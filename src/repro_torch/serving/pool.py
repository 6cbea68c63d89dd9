"""Paged KV pool — the serving engine's memory layer (dense family).

``PagedKVPool`` keeps KV in fixed-size blocks addressed through
per-request block tables.  Whole prompt blocks are shared between requests
copy-on-write — refcounted physical blocks keyed by a chained hash of the
block's tokens — so identical prompt prefixes are prefilled once.
Admission is block-granular: a request reserves ``ceil(tokens /
block_size)`` blocks under an overcommit budget.

The host bookkeeping (tables, refcounts, prefix cache, budget) is the JAX
package's numpy logic unchanged, so both pools make the same decisions
for the same requests.  The KV blocks are torch tensors on the pool's
device, and every write — prefill rows, copy-on-write copies, the decode
step's scatter — updates them *in place* (the JAX pool rebuilds arrays).

Relayout and staged migration (Type I-b reconfiguration) and speculative
write records come with later slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm

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


class PagedKVPool:
    """Paged KV cache with block tables, prefix sharing, and COW."""

    kind = "paged"

    def __init__(self, cfg, setting: dict, max_seq: int, device):
        lm.check_family(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_seq = max_seq
        self.setting = dict(setting)
        self.shared_blocks_hit = 0
        self.cow_copies = 0
        self.cache_evictions = 0
        self._alloc(setting["max_batch"])

    @property
    def overcommit(self) -> float:
        """``block_overcommit`` < 1 limits usable blocks relative to the
        dense worst case; the arrays are always shaped for the worst case,
        so the knob only moves blocks between the free list and a reserved
        set."""
        return float(self.setting.get("block_overcommit", 1.0))

    # ------------------------------------------------------------ allocation
    def _alloc(self, n_slots: int):
        self.n_slots = n_slots
        self.bs = int(self.setting["block_size"])
        self.mb = -(-self.max_seq // self.bs)           # table width
        self.nb = max(n_slots * self.mb, self.mb) + 1   # +1: trash block
        shapes = lm.init_paged_cache_shapes(self.cfg, self.nb, self.bs)
        self.kv = {k: torch.zeros(s, dtype=pool_dtype(self.setting),
                                  device=self.device)
                   for k, s in shapes.items()}
        self.ref = np.zeros(self.nb, np.int32)
        self.ref[TRASH_BLOCK] = 1                       # pinned
        self.tables = np.zeros((n_slots, self.mb), np.int32)
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

    def usable_blocks(self) -> int:
        """The overcommit budget: blocks admission may hold at once."""
        target = int(np.ceil(self.n_slots * self.mb * self.overcommit))
        return min(self.nb - 1, target)

    def _rebalance_budget(self):
        """Move blocks between the free list and the reserved set so that
        held (allocated + prefix-cached) + free == the overcommit budget."""
        target = self.usable_blocks()
        held = (self.nb - 1) - len(self._free) - len(self._reserved)
        while held + len(self._free) < target and self._reserved:
            self._free.add(self._reserved.pop())
        while held + len(self._free) > target and self._free:
            self._reserved.add(self._free.pop())

    @property
    def n_active(self) -> int:
        return sum(self.slot_live)

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
            "kind": self.kind, "n_slots": self.n_slots,
            "live_slots": self.n_active,
            "shared_blocks_hit": self.shared_blocks_hit,
            "cow_copies": self.cow_copies,
            "cache_evictions": self.cache_evictions,
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
    def _alloc_block(self) -> int | None:
        if self._free:
            return self._free.pop()
        # evict the least-recently-touched cached block with refcount 0
        cands = [b for b in self.block_key if self.ref[b] == 0]
        if not cands:
            return None
        victim = min(cands, key=lambda b: self._touch.get(b, 0))
        self._uncache(victim)
        self.cache_evictions += 1
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
        [start, end) is copied into a private block first (in place)."""
        for lb in range(start // self.bs, -(-end // self.bs)):
            b = int(self.tables[slot, lb])
            if self.ref[b] <= 1:
                continue
            nb = self._alloc_block()
            assert nb is not None, "COW block reserved at admission"
            for t in self.kv.values():
                t[:, nb] = t[:, b]
            self.ref[nb] = 1
            self.ref[b] -= 1
            self.tables[slot, lb] = nb
            self.slot_blocks[slot][lb] = nb
            self.cow_copies += 1

    def write_kv(self, slot: int, kv: dict, start: int):
        """Scatter per-token KV rows (L, n, K, hd) into the slot's blocks
        starting at logical position ``start`` (in place)."""
        n = next(iter(kv.values())).shape[1]
        pos = np.arange(start, start + n)
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
        tables (int32, on the pool's device)."""
        return {"k": self.kv["k"], "v": self.kv["v"],
                "block_tables": torch.as_tensor(self.tables,
                                                device=self.device)}

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
