"""Serving state pools — the engine's memory layer.

``StatePool`` is the interface the engine schedules every family through:

  * ``PagedKVPool`` (dense and moe families): KV in fixed-size blocks addressed
    through per-request block tables.  Whole prompt blocks are shared
    between requests copy-on-write — refcounted physical blocks keyed by
    a chained hash of the block's tokens — so identical prompt prefixes
    are prefilled once.  Admission is block-granular: a request reserves
    ``ceil(tokens / block_size)`` blocks under an overcommit budget.
  * ``SSMStatePool`` (ssm and hybrid families): per-slot recurrent state
    (conv window + SSM state).  No sequence axis — a slot is O(1) memory at
    any sequence length, so admission is slot-granular and there is
    nothing to page or share.  The hybrid's shared attention block keeps
    its KV in a dense per-slot slab beside it.

The host bookkeeping (tables, refcounts, prefix cache, budget, slots) is
the JAX package's numpy logic unchanged, so both packages make the same
decisions for the same requests.  The state is torch tensors on the pool's
device, and every write — prefill rows, copy-on-write copies, the decode
step's scatter or state update — changes them *in place* (the JAX pools
rebuild arrays).

The engine's captured steps read the pools by address, so every tensor a
step sees stays where it is until the next relayout: the block tables live
in one device tensor, refreshed from a pinned host mirror only when the
host tables changed, and the ssm pool's speculative snapshot is one
persistent buffer.

Type I-b re-layouts (``relayout``) allocate new tensors and move only the
live rows into them with ``ps.odmr.relocate_rows`` (slots for the ssm
pool, blocks for the paged pool; a block-size change re-blocks every live
slot with one gather and one scatter on the device).  The paged pool can
also migrate in stages (``begin_migration`` ... ``finish_migration``):
background batches copy held blocks into a double buffer while the old
geometry keeps serving, and the commit adopts the staged tensors
themselves, so a step captured against them before the commit is the
step of the new pool.  Either way the tensors the engine's steps captured
are replaced, and the engine drops those steps.

"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.models import lm
from repro_torch.models.attention import identity_tables
from repro_torch.ps.odmr import relocate_rows

TRASH_BLOCK = 0     # physical block 0 is reserved: inactive/padded writes
                    # land there so a stale table row can never corrupt a
                    # live request's blocks


def pool_dtype(setting: dict):
    return (torch.float32 if setting.get("cache_dtype") == "f32"
            else torch.bfloat16)


def _block_chain_key(parent, tokens: np.ndarray):
    """Content hash chain: a block's identity is its tokens *and* its whole
    prefix, so equal blocks at different prompt offsets never alias.  Keys
    hash a canonical int32 byte view — an int64 prompt array from one
    client must match the same tokens submitted as int32."""
    return hash((parent, np.ascontiguousarray(tokens, np.int32).tobytes()))


class StatePool:
    """Interface the ServingEngine schedules against.

    Memory protocol, per request lifetime: ``try_admit(prompt, max_new)``
    reserves a slot (+ memory) or returns None; ``write_kv`` /
    ``write_prefill`` land the prefill state; ``prepare_write`` /
    ``prepare_step_writes`` resolve copy-on-write before any in-place
    write; ``decode_cache`` / ``set_cache`` bracket the decode step;
    ``release(slot)`` returns the memory.  ``exec_key()`` names the pool
    geometry for the step cache."""

    kind = "abstract"
    n_slots = 0
    # counters every pool reports (benchmarks read them)
    shared_blocks_hit = 0
    cow_copies = 0
    cache_evictions = 0
    # units of state the last relayout migrated (paged: KV blocks, ssm:
    # slot rows) — the ReconfigCostModel's load-aware I-b scale
    last_relayout_blocks = 0

    @property
    def n_active(self) -> int:
        return sum(self.slot_live)

    def update_policy(self, setting: dict):
        """Adopt Type II policy knobs (no state relocation).  The paged
        pool also rebalances its overcommit block budget."""
        self.setting = dict(setting)

    def snapshot(self) -> dict:
        """Occupancy/effectiveness counters for the observability layer."""
        return {"kind": self.kind, "n_slots": self.n_slots,
                "live_slots": self.n_active,
                "shared_blocks_hit": self.shared_blocks_hit,
                "cow_copies": self.cow_copies,
                "cache_evictions": self.cache_evictions}


class PagedKVPool(StatePool):
    """Paged KV cache with block tables, prefix sharing, and COW."""

    kind = "paged"

    def __init__(self, cfg, setting: dict, max_seq: int, device):
        lm.check_decodes(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_seq = max_seq
        self.setting = dict(setting)
        self.shared_blocks_hit = 0
        self.cow_copies = 0
        self.cache_evictions = 0
        # staged (double-buffered) migration state — see begin_migration
        self._mig = None
        self._mig_remap: dict[int, int] = {}
        self._mig_copied: set[int] = set()
        self._mig_next = 1
        self.last_migration_bg_blocks = 0     # copied off the commit path
        self.last_migration_delta_blocks = 0  # copied inside the commit
        self._alloc(setting["max_batch"])

    @property
    def overcommit(self) -> float:
        """``block_overcommit`` < 1 limits usable blocks relative to the
        dense worst case; the arrays are always shaped for the worst case,
        so the knob only moves blocks between the free list and a reserved
        set."""
        return float(self.setting.get("block_overcommit", 1.0))

    # ------------------------------------------------------------ allocation
    def _alloc(self, n_slots: int, min_blocks: int = 0):
        self.n_slots = n_slots
        self.bs = int(self.setting["block_size"])
        self.mb = -(-self.max_seq // self.bs)           # table width
        worst = n_slots * self.mb                       # dense worst case
        self.nb = max(worst, self.mb, min_blocks) + 1   # +1: trash block
        # live data must fit even under a tight overcommit budget
        self._budget_floor = min_blocks
        self.kv = self._zeros_kv(self.nb, self.setting)
        self.ref = np.zeros(self.nb, np.int32)
        self.ref[TRASH_BLOCK] = 1                       # pinned
        self.tables = np.zeros((n_slots, self.mb), np.int32)
        (self.dev_tables, self._host_tables,
         self._tables_copied) = self._table_buffers(n_slots)
        self.slot_blocks: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_live = [False] * n_slots
        self._free: set[int] = set()
        self._reserved = set(range(1, self.nb))         # beyond the budget
        # prefix cache: chain key <-> cached physical block (refcount may be
        # 0 — then the block is evictable, LRU by touch order)
        self.prefix: dict[int, int] = {}
        self.block_key: dict[int, int] = {}
        self._touch: dict[int, int] = {}
        self._tick = 0
        self._rebalance_budget()

    def _zeros_kv(self, nb: int, setting: dict) -> dict:
        shapes = lm.init_paged_cache_shapes(self.cfg, nb, self.bs)
        return {k: torch.zeros(s, dtype=pool_dtype(setting),
                               device=self.device)
                for k, s in shapes.items()}

    def _table_buffers(self, n_slots: int):
        """The device block tables the decode step reads (captured by
        address), the pinned host mirror of what they hold, and the event
        of the last copy from it."""
        cuda = self.device.type == "cuda"
        return (torch.zeros((n_slots, self.mb), dtype=torch.int32,
                            device=self.device),
                torch.zeros((n_slots, self.mb), dtype=torch.int32,
                            pin_memory=cuda),
                torch.cuda.Event() if cuda else None)

    def usable_blocks(self) -> int:
        """The overcommit budget: blocks admission may hold at once."""
        target = int(np.ceil(self.n_slots * self.mb * self.overcommit))
        return min(self.nb - 1, max(target, self._budget_floor))

    def _rebalance_budget(self):
        """Move blocks between the free list and the reserved set so that
        held (allocated + prefix-cached) + free == the overcommit budget."""
        target = self.usable_blocks()
        held = (self.nb - 1) - len(self._free) - len(self._reserved)
        while held + len(self._free) < target and self._reserved:
            self._free.add(self._reserved.pop())
        while held + len(self._free) > target and self._free:
            self._reserved.add(self._free.pop())

    def update_policy(self, setting: dict):
        """Adopt policy-only (Type II) knob changes: ``prefix_share`` /
        ``block_overcommit`` take effect immediately, no re-layout."""
        self.setting = dict(setting)
        self._rebalance_budget()

    def evictable_blocks(self) -> int:
        return sum(1 for b in self.block_key if self.ref[b] == 0)

    def exec_key(self) -> tuple:
        return ("paged", self.n_slots, self.nb, self.bs,
                self.setting.get("cache_dtype"))

    def snapshot(self) -> dict:
        """Block-level occupancy: how much of the overcommit budget live
        requests + the prefix cache actually hold right now."""
        usable = self.usable_blocks()
        held = (self.nb - 1) - len(self._free) - len(self._reserved)
        return {
            **super().snapshot(),
            "block_size": self.bs,
            "blocks_total": self.nb - 1,
            "blocks_usable": usable,
            "blocks_held": held,
            "blocks_free": len(self._free),
            "block_utilization": held / max(usable, 1),
            "prefix_cached_blocks": len(self.block_key),
            "evictable_blocks": self.evictable_blocks(),
        }

    # ------------------------------------------------------- block plumbing
    def _mig_mark(self, block: int):
        """A block is about to be (re)written: any staged-migration copy of
        it is stale.  Every write path calls this before it queues its
        device write (block reuse in _alloc_block, copy-on-write and the
        write range in prepare_spec_write, write_kv), so the background
        copy never misses an update — the block rejoins the to-copy set."""
        if self._mig is not None:
            self._mig_copied.discard(block)

    def _alloc_block(self) -> int | None:
        if self._free:
            b = self._free.pop()
            self._mig_mark(b)
            return b
        # evict the least-recently-touched cached block with refcount 0
        cands = [b for b in self.block_key if self.ref[b] == 0]
        if not cands:
            return None
        victim = min(cands, key=lambda b: self._touch.get(b, 0))
        self._uncache(victim)
        self.cache_evictions += 1
        self._mig_mark(victim)
        return victim

    def _uncache(self, block: int):
        key = self.block_key.pop(block, None)
        if key is not None:
            self.prefix.pop(key, None)
        self._touch.pop(block, None)

    def _release_block(self, block: int):
        self.ref[block] -= 1
        assert self.ref[block] >= 0
        if self.ref[block] == 0 and block not in self.block_key:
            self._free.add(block)
            self._rebalance_budget()

    # ------------------------------------------------------------ invariants
    def check_invariants(self):
        """Assert the pool's full accounting is self-consistent: refcount
        conservation, free/table/reserved disjointness and partition,
        the overcommit budget at its fixed point, and prefix keys that
        resolve back to their blocks.  For tests, not the hot path."""
        counts: dict[int, int] = {}
        for slot, live in enumerate(self.slot_live):
            blocks = self.slot_blocks[slot]
            if not live:
                assert blocks == [], \
                    f"dead slot {slot} still holds blocks {blocks}"
                assert all(b == TRASH_BLOCK for b in self.tables[slot]), \
                    f"dead slot {slot} has live table entries"
                continue
            for lb, b in enumerate(blocks):
                assert b != TRASH_BLOCK, \
                    f"slot {slot} tabled the trash block at {lb}"
                assert self.tables[slot, lb] == b, \
                    f"slot {slot} lb {lb}: table {self.tables[slot, lb]} " \
                    f"!= slot_blocks {b}"
                counts[b] = counts.get(b, 0) + 1
            for lb in range(len(blocks), self.mb):
                assert self.tables[slot, lb] == TRASH_BLOCK, \
                    f"slot {slot}: stale table entry past its blocks at {lb}"
        for b, n in counts.items():
            assert self.ref[b] == n, f"block {b}: ref {self.ref[b]} != {n}"
        for b in range(1, self.nb):
            if b not in counts:
                assert self.ref[b] == 0, \
                    f"block {b}: ref {self.ref[b]} with no table reference"
        held = {b for b in range(1, self.nb)
                if self.ref[b] > 0 or b in self.block_key}
        assert not (held & self._free), "free list overlaps held blocks"
        assert not (held & self._reserved), "reserved set overlaps held"
        assert not (self._free & self._reserved), "free/reserved overlap"
        assert held | self._free | self._reserved == set(range(1, self.nb)), \
            "block leak: some physical block is in no accounting set"
        target = self.usable_blocks()
        if len(held) <= target:
            assert len(held) + len(self._free) == target, \
                f"budget: held {len(held)} + free {len(self._free)} " \
                f"!= target {target}"
        else:
            assert not self._free, \
                f"budget: held {len(held)} > target {target} with a " \
                f"non-empty free list"
        for key, b in self.prefix.items():
            assert self.block_key.get(b) == key, \
                f"prefix key {key} -> block {b} does not resolve back"

    # ------------------------------------------------------------- admission
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        tokens = min(prompt_len + max_new, self.max_seq)
        return -(-tokens // self.bs)

    def try_admit(self, prompt: np.ndarray, max_new: int):
        """Reserve a slot + blocks for the request.  Returns
        ``(slot, shared_len)`` — ``shared_len`` tokens of the prompt already
        have KV in (refcounted) shared blocks — or None if slots or blocks
        are exhausted.  A failed reservation rolls back."""
        slot = next((i for i, live in enumerate(self.slot_live) if not live),
                    None)
        if slot is None:
            return None
        P = len(prompt)
        total_blocks = self.blocks_needed(P, max_new)

        matched: list[int] = []
        chain = 0
        keys: list[int] = []          # chain key per full prompt block
        for i in range(P // self.bs):
            chain = _block_chain_key(chain, prompt[i * self.bs:
                                                  (i + 1) * self.bs])
            keys.append(chain)
        if self.setting.get("prefix_share"):
            for key in keys:
                b = self.prefix.get(key)
                if b is None:
                    break
                matched.append(b)
        shared_len = len(matched) * self.bs
        # always recompute >= 1 token so admission yields first-token logits;
        # a full-prompt match then writes into the last shared block -> COW
        suffix_start = min(shared_len, P - 1)
        needs_cow = suffix_start < shared_len

        blocks = list(matched)
        for b in matched:
            self.ref[b] += 1
            self._free.discard(b)
            self._tick += 1
            self._touch[b] = self._tick
        # capacity check BEFORE any eviction, so a doomed admission does not
        # strip the prefix cache on its way to a rollback
        need = total_blocks - len(matched) + (1 if needs_cow else 0)
        if len(self._free) + self.evictable_blocks() < need:
            for b in matched:
                self._release_block(b)
            return None
        for _ in range(total_blocks - len(matched)):
            b = self._alloc_block()
            assert b is not None, "capacity was checked above"
            self.ref[b] = 1
            blocks.append(b)

        self.shared_blocks_hit += len(matched)
        self.tables[slot, :] = TRASH_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        self.slot_blocks[slot] = blocks
        self.slot_live[slot] = True
        # register this request's full prompt blocks so later identical
        # prompts share them (only while sharing is on)
        if self.setting.get("prefix_share"):
            for key, b in zip(keys, blocks):
                if key not in self.prefix and self.ref[b] >= 1:
                    self.prefix[key] = b
                    self.block_key[b] = key
                    self._tick += 1
                    self._touch[b] = self._tick
        return slot, suffix_start

    def release(self, slot: int):
        for b in self.slot_blocks[slot]:
            self._release_block(b)
        self.slot_blocks[slot] = []
        self.tables[slot, :] = TRASH_BLOCK
        self.slot_live[slot] = False

    # -------------------------------------------------------------- writing
    def prepare_write(self, slot: int, start: int, end: int):
        """Copy-on-write: any shared block overlapping write range
        [start, end) is copied into a private block first (in place).  A
        speculative write settled at once: the shared block keeps another
        reference, so the drop never frees it."""
        for _, old, _ in self.prepare_spec_write(slot, start, end):
            self._release_block(old)

    def prepare_spec_write(self, slot: int, start: int, end: int):
        """Copy-on-write for a *speculative* write range [start, end).

        Like ``prepare_write``, but the shared block's refcount drop is
        deferred: rolling a rejected tail back must restore the original
        block, and an eager decrement could free it (or hand it to another
        request) mid-tick.  Returns rollback records
        ``[(logical_block, old_physical, new_physical), ...]`` that
        ``commit_spec_write`` settles after the verify step."""
        recs = []
        for lb in range(start // self.bs, -(-end // self.bs)):
            b = int(self.tables[slot, lb])
            self._mig_mark(b)     # caller writes [start, end) after this
            if self.ref[b] <= 1:
                continue
            nb = self._alloc_block()
            assert nb is not None, "COW block reserved at admission"
            for t in self.kv.values():
                t[:, nb] = t[:, b]
            self.ref[nb] = 1
            # ref[b] is NOT decremented here — commit_spec_write settles
            # it: release on keep, restore on rollback
            self.tables[slot, lb] = nb
            self.slot_blocks[slot][lb] = nb
            self.cow_copies += 1
            recs.append((lb, b, nb))
        return recs

    def commit_spec_write(self, slot: int, recs, accepted_end: int):
        """Settle a speculative write's COW records: a copy covering any
        accepted position (block start < ``accepted_end``) is kept and the
        old shared block finally dropped; a copy covering only rejected
        positions is undone — the table entry is restored and the private
        copy freed.  Rejected rows need no scrubbing: every decode step
        re-resolves COW and rewrites its KV rows in-step before attention
        reads them, and attention masks ``kvp <= q_pos``."""
        for lb, old, new in recs:
            if lb * self.bs < accepted_end:
                self._release_block(old)      # the deferred decrement
            else:
                self.tables[slot, lb] = old
                self.slot_blocks[slot][lb] = old
                self._release_block(new)      # 1 -> 0: back to free list

    def write_kv(self, slot: int, kv: dict, start: int):
        """Scatter per-token KV rows (L, n, K, hd) into the slot's blocks
        starting at logical position ``start`` (in place)."""
        n = next(iter(kv.values())).shape[1]
        pos = np.arange(start, start + n)
        for b in set(self.tables[slot, pos // self.bs].tolist()):
            self._mig_mark(b)
        blk = torch.as_tensor(self.tables[slot, pos // self.bs],
                              dtype=torch.long, device=self.device)
        off = torch.as_tensor(pos % self.bs, dtype=torch.long,
                              device=self.device)
        for k, rows in kv.items():
            self.kv[k][:, blk, off] = rows.to(self.kv[k].dtype)

    # --------------------------------------------------------------- decode
    def decode_cache(self) -> dict:
        """Operands of the decode step: the physical KV block pools — what
        the paged-attention kernel reads in place — plus the per-slot block
        tables, ``dev_tables``: one int32 device tensor for the pool's life,
        brought up to date with the host tables here when they changed
        (admission, copy-on-write, release), by an asynchronous copy from a
        pinned mirror (a pageable copy would wait for the device's queue)."""
        host = self._host_tables.numpy()
        if not np.array_equal(host, self.tables):
            if self._tables_copied is not None:
                self._tables_copied.synchronize()   # the last copy has read
            host[...] = self.tables                 # the mirror
            self.dev_tables.copy_(self._host_tables, non_blocking=True)
            if self._tables_copied is not None:
                self._tables_copied.record()
        return {"k": self.kv["k"], "v": self.kv["v"],
                "block_tables": self.dev_tables}

    def set_cache(self, new_cache: dict):
        """Adopt the block pools a decode / chunked-prefill step returns
        (the same tensors, written in place)."""
        self.kv = {"k": new_cache["k"], "v": new_cache["v"]}

    def prepare_step_writes(self, slots, positions):
        """Resolve copy-on-write for the single position each live slot
        will write this tick."""
        for s in slots:
            p = int(positions[s])
            self.prepare_write(s, p, p + 1)

    # -------------------------------------------------------------- relayout
    def relayout(self, new_setting: dict, live_extents: dict,
                 min_slots: int = 0) -> dict:
        """Type I-b re-layout into the geometry of ``new_setting``, into new
        tensors (the engine drops the steps captured on the old ones).

        ``live_extents``: {slot: (tokens_written, tokens_reserved)} for live
        slots.  Same block size: only live + (capacity permitting) cached
        blocks migrate, tables are remapped.  Block-size change: each live
        slot's logical KV is re-blocked (the prefix cache cannot survive —
        its keys are per block geometry — so it resets), with one gather
        from the old pool and one scatter into the new on the device.
        Returns {old_slot: new_slot}."""
        if self._mig is not None:      # staged migration superseded
            self.abort_migration()
        old_bs = self.bs
        old_kv, old_tables = self.kv, self.tables
        old_blocks = {s: list(bl) for s, bl in enumerate(self.slot_blocks)}
        old_key = dict(self.block_key)
        old_touch = dict(self._touch)
        old_ref = self.ref
        live = sorted(live_extents)

        # live data must fit even in an under-provisioned (overcommitted)
        # new pool: floor the block count at what the live set needs
        new_bs = int(new_setting["block_size"])
        if new_bs == old_bs:
            min_blocks = len({b for s in live for b in old_blocks[s]})
        else:
            min_blocks = sum(
                -(-max(live_extents[s][1], live_extents[s][0], 1) // new_bs)
                for s in live)
        self.setting = dict(new_setting)
        self._alloc(max(int(new_setting["max_batch"]), len(live), min_slots,
                        1), min_blocks=min_blocks)
        mapping = {s: i for i, s in enumerate(live)}

        if self.bs == old_bs:
            # block-granular migration: live blocks always move; cached
            # (refcount-0) blocks move while free space remains, LRU first
            keep = []
            seen = set()
            for s in live:
                for b in old_blocks[s]:
                    if b not in seen:
                        seen.add(b)
                        keep.append(b)
            cached = sorted((b for b in old_key
                             if old_ref[b] == 0 and b not in seen),
                            key=lambda b: -old_touch.get(b, 0))
            budget = self.usable_blocks() - len(keep)
            dropped = cached[max(budget, 0):]
            self.cache_evictions += len(dropped)
            keep.extend(cached[:max(budget, 0)])
            remap = {b: i + 1 for i, b in enumerate(keep)}
            relocate_rows(old_kv, self.kv, keep, [remap[b] for b in keep])
            for s in live:
                ns = mapping[s]
                self.slot_blocks[ns] = [remap[b] for b in old_blocks[s]]
                self.tables[ns, :len(self.slot_blocks[ns])] = \
                    self.slot_blocks[ns]
                self.slot_live[ns] = True
            for s in live:
                for b in self.slot_blocks[mapping[s]]:
                    self.ref[b] += 1
            for b, key in old_key.items():
                if b in remap:
                    nb = remap[b]
                    self.block_key[nb] = key
                    self.prefix[key] = nb
                    self._touch[nb] = old_touch.get(b, 0)
            self._tick = max(old_touch.values(), default=0)
            moved = {remap[b] for b in keep}
            self._free -= moved
            self._reserved -= moved
            self._rebalance_budget()
            self.last_relayout_blocks = len(keep)
        else:
            # re-block: reserve new-size blocks for every live slot, then
            # move each slot's written rows [0, written) from (old block,
            # offset) to (new block, offset) — one gather and one scatter
            # a leaf, on the device, over index tensors of every slot
            self.last_relayout_blocks = 0
            idx = []                   # (old blk, old off, new blk, new off)
            for s in live:
                written, reserved = live_extents[s]
                ns = mapping[s]
                n_blocks = -(-max(reserved, written, 1) // self.bs)
                blocks = []
                for _ in range(n_blocks):
                    b = self._alloc_block()
                    assert b is not None, "shrunk pool cannot hold live data"
                    self.ref[b] = 1
                    blocks.append(b)
                self.slot_blocks[ns] = blocks
                self.tables[ns, :len(blocks)] = blocks
                self.slot_live[ns] = True
                self.last_relayout_blocks += len(blocks)
                pos = np.arange(written)
                idx.append((old_tables[s, pos // old_bs], pos % old_bs,
                            self.tables[ns, pos // self.bs], pos % self.bs))
            if any(len(i[0]) for i in idx):
                ob, oo, nb_, no = (
                    torch.as_tensor(np.concatenate(c), dtype=torch.long,
                                    device=self.device) for c in zip(*idx))
                for k, t in self.kv.items():
                    t[:, nb_, no] = old_kv[k][:, ob, oo].to(t.dtype)
        # the budget floor only has to hold while live data is being
        # migrated; once the live set owns its blocks, the configured
        # overcommit budget governs again
        self._budget_floor = 0
        self._rebalance_budget()
        return mapping

    # ------------------------------------------- staged (overlapped) migration
    # A Type I-b relayout split into background batches: begin_migration
    # allocates the target tensors (the double buffer, with its own block
    # tables and pinned mirror), migration_step copies bounded batches of
    # held blocks between engine ticks while the old geometry keeps
    # decoding, and finish_migration copies only the blocks dirtied since
    # their background copy (the delta), rebuilds the tables and adopts
    # the staged tensors themselves.  Correctness rests on two invariants:
    # every write path marks its blocks via _mig_mark *before* it queues
    # the device write (so a copied block that mutates rejoins the to-copy
    # set), and the copies only read the old tensors and only write the
    # staged ones, on the stream the decode steps run on, so each copy
    # sees every write queued before it.

    def begin_migration(self, new_setting: dict) -> bool:
        """Stage a migration into ``new_setting``'s canonical geometry
        (n_slots = max_batch, the geometry the engine captures the staged
        decode steps for).  Returns False when the move cannot run
        incrementally — a block-size change re-blocks every row, so the
        caller falls back to the stop-the-world relayout."""
        assert self._mig is None, "migration already staged"
        if int(new_setting["block_size"]) != self.bs:
            return False
        n_slots = max(int(new_setting["max_batch"]), 1)
        nb = n_slots * self.mb + 1
        setting = dict(new_setting)
        dev, host, ev = self._table_buffers(n_slots)
        self._mig = {"setting": setting, "kv": self._zeros_kv(nb, setting),
                     "nb": nb, "n_slots": n_slots, "dev_tables": dev,
                     "host_tables": host, "tables_copied": ev}
        self._mig_remap = {}
        self._mig_copied = set()
        self._mig_next = 1
        self.last_migration_bg_blocks = 0
        return True

    def staged_cache(self) -> dict:
        """The staged tensors as a decode step takes them (``decode_cache``
        of the pool the commit will adopt)."""
        mig = self._mig
        return {"k": mig["kv"]["k"], "v": mig["kv"]["v"],
                "block_tables": mig["dev_tables"]}

    def _held_blocks(self) -> list[int]:
        """Blocks the pool is responsible for migrating: referenced by a
        live slot or registered in the prefix cache."""
        refd = (np.nonzero(self.ref[1:] > 0)[0] + 1).tolist()
        return sorted(set(refd) | set(self.block_key))

    def migration_pending(self, skip=()) -> int:
        """Held blocks still awaiting a clean background copy (excluding
        ``skip`` — the caller's hot set, which would be dirtied again next
        tick and is deferred to the commit delta)."""
        mig = self._mig
        return sum(1 for b in self._held_blocks()
                   if b not in self._mig_copied and b not in skip
                   and (b in self._mig_remap or self._mig_next < mig["nb"]))

    def migration_step(self, max_blocks: int = 8, skip=()) -> int:
        """Copy up to ``max_blocks`` cold held blocks into the staged
        tensors and wait for the copy; returns how many assignable blocks
        remain uncopied.  Blocks the target has no row for (a shrink
        holding more cache than the new budget) are left to
        finish_migration, which drops or delta-copies them under the final
        budget."""
        assert self._mig is not None
        mig = self._mig
        todo = [b for b in self._held_blocks()
                if b not in self._mig_copied and b not in skip]
        batch = []
        for b in todo:
            if len(batch) >= max_blocks:
                break
            if b not in self._mig_remap:
                if self._mig_next >= mig["nb"]:
                    continue          # no target row yet: commit-time work
                self._mig_remap[b] = self._mig_next
                self._mig_next += 1
            batch.append(b)
        if batch:
            relocate_rows(self.kv, mig["kv"], batch,
                          [self._mig_remap[b] for b in batch])
            synchronize(self.device)
            self._mig_copied.update(batch)
            self.last_migration_bg_blocks += len(batch)
        return self.migration_pending(skip=skip)

    def finish_migration(self, live_extents: dict) -> dict | None:
        """Atomic swap: delta-copy every kept block whose background copy
        is missing or stale, rebuild tables/refcounts/prefix keys against
        the staged tensors, and adopt them (the KV, the device tables and
        their pinned mirror).  Returns {old_slot: new_slot}, or None when
        the live set no longer fits the staged geometry (the caller aborts
        and falls back to the stop-the-world relayout)."""
        assert self._mig is not None
        mig = self._mig
        live = sorted(live_extents)
        if len(live) > mig["n_slots"]:
            return None

        # keep list, exactly as the stop-the-world relayout orders it:
        # live blocks in slot order, then cached blocks by recency within
        # the new overcommit budget
        keep, seen = [], set()
        for s in live:
            for b in self.slot_blocks[s]:
                if b not in seen:
                    seen.add(b)
                    keep.append(b)
        cached = sorted((b for b in self.block_key
                         if self.ref[b] == 0 and b not in seen),
                        key=lambda b: -self._touch.get(b, 0))
        oc = float(mig["setting"].get("block_overcommit", 1.0))
        usable = min(mig["nb"] - 1,
                     max(int(np.ceil(mig["n_slots"] * self.mb * oc)),
                         len(keep)))
        budget = usable - len(keep)
        dropped = cached[max(budget, 0):]
        self.cache_evictions += len(dropped)
        keep.extend(cached[:max(budget, 0)])

        # final id assignment: clean background copies keep their row,
        # everything else takes a row not used by a kept clean copy
        used = {self._mig_remap[b] for b in keep
                if b in self._mig_remap and b in self._mig_copied}
        free_ids = (i for i in range(1, mig["nb"]) if i not in used)
        remap, delta = {}, []
        for b in keep:
            if b in self._mig_remap and b in self._mig_copied:
                remap[b] = self._mig_remap[b]
            else:
                remap[b] = next(free_ids)
                delta.append(b)
        relocate_rows(self.kv, mig["kv"], delta, [remap[b] for b in delta])
        self.last_migration_delta_blocks = len(delta)

        old_blocks = {s: list(self.slot_blocks[s]) for s in live}
        old_key = dict(self.block_key)
        old_touch = dict(self._touch)
        mapping = {s: i for i, s in enumerate(live)}

        # adopt the staged tensors + geometry
        self.setting = mig["setting"]
        self.n_slots = mig["n_slots"]
        self.nb = mig["nb"]
        self.kv = mig["kv"]
        self.dev_tables = mig["dev_tables"]
        self._host_tables = mig["host_tables"]
        self._tables_copied = mig["tables_copied"]
        self.ref = np.zeros(self.nb, np.int32)
        self.ref[TRASH_BLOCK] = 1
        self.tables = np.zeros((self.n_slots, self.mb), np.int32)
        self.slot_blocks = [[] for _ in range(self.n_slots)]
        self.slot_live = [False] * self.n_slots
        self.prefix, self.block_key, self._touch = {}, {}, {}
        for s in live:
            ns = mapping[s]
            self.slot_blocks[ns] = [remap[b] for b in old_blocks[s]]
            self.tables[ns, :len(self.slot_blocks[ns])] = \
                self.slot_blocks[ns]
            self.slot_live[ns] = True
            for b in self.slot_blocks[ns]:
                self.ref[b] += 1
        for b, key in old_key.items():
            if b in remap:
                nb_ = remap[b]
                self.block_key[nb_] = key
                self.prefix[key] = nb_
                self._touch[nb_] = old_touch.get(b, 0)
        self._tick = max(old_touch.values(), default=0)
        held = set(remap.values())
        self._free = set()
        self._reserved = set(range(1, self.nb)) - held
        self._budget_floor = 0
        self._rebalance_budget()
        self.last_relayout_blocks = len(keep)
        self._mig = None
        self._mig_remap, self._mig_copied = {}, set()
        return mapping

    def abort_migration(self):
        """Drop the staged tensors; the old geometry stays authoritative."""
        self._mig = None
        self._mig_remap, self._mig_copied = {}, set()
        self.last_migration_bg_blocks = 0

    def mb_of(self, bs: int) -> int:
        return -(-self.max_seq // bs)


class SSMStatePool(StatePool):
    """Per-slot recurrent state for the ssm and hybrid families.

    State has no sequence axis (conv window + SSM state are O(1) per slot),
    so admission is slot-granular and there is nothing to page or share.
    The hybrid family's shared-attention KV rides along as a dense slab of
    per-slot rows (``shared_k`` / ``shared_v``, (n_apps, slots, max_seq, K,
    hd)), read through one identity block table (``slab_tables``).
    ``cache_dtype`` applies to the conv window and the slab; the SSM state
    ``h`` stays float32 — the recurrence accumulates, and truncating it is
    a correctness knob, not an efficiency knob.  Every leaf has its slot on
    axis 1."""

    kind = "ssm"
    # the leaves a speculative verify must roll back: the slab's rows of
    # rejected positions are masked (kv position <= query position) and
    # rewritten in-step before any query reads them, so they need none
    SNAPSHOT = ("conv", "h")

    def __init__(self, cfg, setting: dict, max_seq: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_seq = max_seq          # the slab's rows (hybrid only)
        self.setting = dict(setting)
        self._alloc(int(setting["max_batch"]))

    def _alloc(self, n_slots: int):
        self.n_slots = n_slots
        dt = pool_dtype(self.setting)
        shapes = lm.init_cache_shapes(self.cfg, n_slots, self.max_seq)
        self.state = {k: torch.zeros(s, dtype=torch.float32 if k == "h"
                                     else dt, device=self.device)
                      for k, s in shapes.items()}
        self.slab_tables = (identity_tables(n_slots, self.max_seq,
                                            self.device)
                            if "shared_k" in self.state else None)
        self.slot_live = [False] * n_slots
        self.saved = None         # the speculative snapshot (save_state)

    def exec_key(self) -> tuple:
        return ("ssm", self.n_slots, self.setting.get("cache_dtype"))

    def save_state(self) -> dict:
        """Copy every slot's ``SNAPSHOT`` leaves into one persistent buffer
        (allocated at the first call, then reused: the replay steps capture
        it by address) and return it, as a decode cache whose other leaves
        (the slab and its tables) are the pool's own.  The decode step
        writes the state in place, so a speculative verify needs this real
        copy to roll back from."""
        if self.saved is None:
            self.saved = self.decode_cache()
            self.saved.update({k: torch.empty_like(self.state[k])
                               for k in self.SNAPSHOT})
        for k in self.SNAPSHOT:
            self.saved[k].copy_(self.state[k])
        return self.saved

    def try_admit(self, prompt: np.ndarray, max_new: int):
        """Slot-granular admission: recurrent state is O(1) per request,
        so the only resource is a free slot.  ``shared_len`` is always 0
        — there is no prefix KV to share."""
        slot = next((i for i, live in enumerate(self.slot_live) if not live),
                    None)
        if slot is None:
            return None
        self.slot_live[slot] = True
        return slot, 0

    def release(self, slot: int):
        """Return the slot; its state is overwritten by the next
        admission."""
        self.slot_live[slot] = False

    def write_prefill(self, slot: int, pcache: dict, P: int):
        """Land a batch-1 prefill's state in ``slot`` (in place, cast to the
        pool's dtypes): the (L, 1, ...) leaves whole (the prefill already
        stopped its state at the last prompt token, ``valid_len``), the
        hybrid's (n_apps, 1, bucket, K, hd) KV rows up to the prompt's
        length ``P``."""
        for k, v in pcache.items():
            if k.startswith("shared"):
                self.state[k][:, slot, :P] = v[:, 0, :P]
            else:
                self.state[k][:, slot] = v[:, 0]

    def decode_cache(self) -> dict:
        """Operands of the decode step: the pool's own state tensors, which
        the step updates in place (and the slab's block tables)."""
        cache = dict(self.state)
        if self.slab_tables is not None:
            cache["slab_tables"] = self.slab_tables
        return cache

    def set_cache(self, new_cache: dict):
        """Adopt the state a decode step returns, pinned to the pool's
        dtypes (h f32, conv and slab the pool dtype)."""
        self.state = {k: new_cache[k].to(self.state[k].dtype)
                      for k in self.state}

    def prepare_step_writes(self, slots, positions):
        pass                                  # recurrent state: no COW

    def relayout(self, new_setting: dict, live_extents: dict,
                 min_slots: int = 0) -> dict:
        """Type I-b re-layout: new state tensors for ``new_setting``'s slot
        count and dtype, the live slots' rows moved into them in slot order
        along axis 1 of every leaf (conv and slab cast to the new dtype, h
        stays f32).  The speculative snapshot goes with the old tensors.
        Returns {old_slot: new_slot}."""
        live = sorted(live_extents)
        old_state = self.state
        self.setting = dict(new_setting)
        self._alloc(max(int(new_setting["max_batch"]), len(live), min_slots,
                        1))
        mapping = {s: i for i, s in enumerate(live)}
        relocate_rows(old_state, self.state, live, [mapping[s] for s in live])
        self.last_relayout_blocks = len(live)
        for s in live:
            self.slot_live[mapping[s]] = True
        return mapping


def make_state_pool(cfg, setting: dict, max_seq: int, device):
    """Family dispatch: paged KV for the dense, moe and vlm families,
    recurrent-state slots for the ssm and hybrid families; the encoder
    raises ``NotImplementedError``: it has no decode step (as in the JAX
    package)."""
    lm.check_decodes(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return SSMStatePool(cfg, setting, max_seq, device)
    return PagedKVPool(cfg, setting, max_seq, device)
