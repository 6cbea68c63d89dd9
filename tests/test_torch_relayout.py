"""PyTorch port: Type I-b reconfiguration of the state pools against the
JAX package's pools — ``relayout`` (same block size, a re-block, a shrink
held at ``min_slots``, a dtype change) and the staged migration (background
copies, a write to a copied block, the commit) replayed in lockstep on
both: equal tables, refcounts, prefix keys, free lists and counters, and
the same KV bit for bit (so the same logical KV through the tables)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro.serving.pool import PagedKVPool as JPool
from repro.serving.pool import SSMStatePool as JSSMPool
from repro_torch.configs.registry import get_config as torch_get_config
from repro_torch.serving.pool import PagedKVPool as TPool
from repro_torch.serving.pool import SSMStatePool as TSSMPool

from _torch_port import f32

MAX_SEQ = 48
CFG = get_config("starcoder2-3b").reduced()
TCFG = torch_get_config("starcoder2-3b").reduced()


def _setting(**kw):
    return dict(DEFAULT_SERVING_SETTING, **kw)


def _logical(pool, slot, written):
    """A slot's KV rows [0, written) read through its block table."""
    out = {}
    for k, v in pool.kv.items():
        a = f32(v)                                  # (L, nb, bs, K, hd)
        g = a[:, np.asarray(pool.tables[slot])]
        out[k] = g.reshape(a.shape[0], -1, a.shape[3], a.shape[4])[
            :, :written]
    return out


def _same(jp, tp, live=None):
    np.testing.assert_array_equal(tp.tables, jp.tables)
    np.testing.assert_array_equal(tp.ref, jp.ref)
    assert tp.slot_blocks == jp.slot_blocks
    assert tp.slot_live == jp.slot_live
    assert tp.prefix == jp.prefix and tp.block_key == jp.block_key
    assert tp._touch == jp._touch and tp._tick == jp._tick
    assert tp._free == jp._free and tp._reserved == jp._reserved
    for c in ("shared_blocks_hit", "cow_copies", "cache_evictions",
              "last_relayout_blocks"):
        assert getattr(tp, c) == getattr(jp, c), c
    assert tp.exec_key() == jp.exec_key()
    assert tp.snapshot() == jp.snapshot()
    for k in ("k", "v"):                 # block 0 is the trash block
        assert tp.kv[k].dtype == (torch.float32 if jp.kv[k].dtype
                                  == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(f32(tp.kv[k])[:, 1:],
                                      f32(jp.kv[k])[:, 1:])
    for s, w in (live or {}).items():
        a, b = _logical(jp, s, w), _logical(tp, s, w)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    jp.check_invariants()
    tp.check_invariants()


class Lockstep:
    """One admit / write / copy-on-write / release script on both pools."""

    def __init__(self, setting, seed=3):
        self.jp = JPool(CFG, setting, max_seq=MAX_SEQ)
        self.tp = TPool(TCFG, setting, max_seq=MAX_SEQ, device="cpu")
        self.rng = np.random.default_rng(seed)

    def admit(self, prompt, max_new):
        a = self.jp.try_admit(prompt, max_new)
        assert self.tp.try_admit(prompt, max_new) == a
        return a

    def write(self, slot, start, n):
        L, K, hd = CFG.n_layers, CFG.n_kv_heads, CFG.hd
        rows = {k: self.rng.standard_normal((L, n, K, hd)).astype(np.float32)
                for k in "kv"}
        self.jp.write_kv(slot, {k: jnp.asarray(v) for k, v in rows.items()},
                         start)
        self.tp.write_kv(slot, {k: torch.from_numpy(v)
                                for k, v in rows.items()}, start)

    def cow(self, slot, start, end):
        self.jp.prepare_write(slot, start, end)
        self.tp.prepare_write(slot, start, end)

    def release(self, slot):
        self.jp.release(slot)
        self.tp.release(slot)

    def tokens(self, n):
        return self.rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)


def _populated(setting):
    """Three live slots (one shares two prefix blocks, one is a whole-prompt
    match with its COW copy) and a released one whose prompt blocks stay
    in the prefix cache.  Returns the lockstep pools and {slot: (written,
    reserved)}."""
    ls = Lockstep(setting)
    base = ls.tokens(19)
    a, _ = ls.admit(base, 6)
    ls.write(a, 0, 19)
    b, shared = ls.admit(np.concatenate([base[:16], ls.tokens(5)]), 4)
    assert shared == 16
    ls.cow(b, 16, 21)
    ls.write(b, 16, 5)
    c, shared = ls.admit(base[:16].copy(), 3)
    assert shared == 15
    ls.cow(c, 15, 16)
    ls.write(c, 15, 1)
    ls.release(a)                        # its blocks stay cached
    d, _ = ls.admit(ls.tokens(9), 7)
    ls.write(d, 0, 9)
    live = {b: (21, 25), c: (16, 19), d: (9, 16)}
    _same(ls.jp, ls.tp, {s: w for s, (w, _) in live.items()})
    return ls, live


RELAYOUTS = {
    "same_block_size": (dict(cache_dtype="f32"), dict(max_batch=4), 0),
    "reblock": (dict(cache_dtype="f32"), dict(block_size=16), 0),
    "shrink_min_slots": (dict(cache_dtype="bf16"), dict(max_batch=1), 3),
    "dtype": (dict(cache_dtype="bf16"), dict(cache_dtype="f32"), 0),
    "dtype_down_reblock": (dict(cache_dtype="f32"),
                           dict(cache_dtype="bf16", block_size=16), 0),
}


@pytest.mark.parametrize("case", list(RELAYOUTS))
def test_relayout_matches_jax(case):
    start, change, min_slots = RELAYOUTS[case]
    setting = _setting(max_batch=3, block_size=8, prefix_share=True,
                       block_overcommit=0.8, **start)
    ls, live = _populated(setting)
    before = {s: _logical(ls.tp, s, w) for s, (w, _) in live.items()}
    new = dict(setting, **change)
    mj = ls.jp.relayout(new, live, min_slots=min_slots)
    mt = ls.tp.relayout(new, live, min_slots=min_slots)
    assert mt == mj
    moved = {mt[s]: w for s, (w, _) in live.items()}
    _same(ls.jp, ls.tp, moved)
    assert ls.tp.n_slots == max(new["max_batch"], len(live), min_slots)
    # the logical rows moved unchanged (or cast exactly to the new dtype)
    dt = torch.float32 if new["cache_dtype"] == "f32" else torch.bfloat16
    for s, (w, _) in live.items():
        got = _logical(ls.tp, mt[s], w)
        for k, rows in before[s].items():
            want = torch.from_numpy(rows).to(dt).float().numpy()
            np.testing.assert_array_equal(got[k], want)
    if new["block_size"] != setting["block_size"]:
        assert ls.tp.prefix == {}          # keys are per block geometry
    # both keep allocating the same blocks (or refusing the same request)
    for s in sorted(mt.values())[:1]:
        ls.release(s)
    e, _ = ls.admit(ls.tokens(12), 5)
    ls.write(e, 0, 12)
    _same(ls.jp, ls.tp)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_staged_migration_matches_jax(cache_dtype):
    """Background copies in batches, then a write into a block already
    copied (it must rejoin the to-copy set), an admission that reuses a
    block, more batches, and the commit: both pools land on the same
    tables and the same KV, and the port adopts the staged tensors."""
    setting = _setting(max_batch=3, block_size=8, prefix_share=True,
                       cache_dtype=cache_dtype)
    ls, live = _populated(setting)
    target = dict(setting, max_batch=4)
    assert ls.jp.begin_migration(target) and ls.tp.begin_migration(target)
    staged = ls.tp.staged_cache()
    for _ in range(2):
        assert (ls.tp.migration_step(2) == ls.jp.migration_step(2))
    assert ls.tp._mig_copied == ls.jp._mig_copied
    # a private block of a live slot that was copied already
    b, lb = next((s, lb) for s in sorted(live)
                 for lb, blk in enumerate(ls.tp.slot_blocks[s])
                 if blk in ls.tp._mig_copied and ls.tp.ref[blk] == 1)
    copied = ls.tp.slot_blocks[b][lb]
    ls.cow(b, lb * 8, lb * 8 + 2)
    ls.write(b, lb * 8, 2)                 # dirties the copied block
    assert copied not in ls.tp._mig_copied
    assert ls.tp._mig_copied == ls.jp._mig_copied
    hot = {ls.tp.slot_blocks[s][-1] for s in live}
    while ls.jp.migration_pending(skip=hot) > 0:
        assert (ls.tp.migration_step(3, skip=hot)
                == ls.jp.migration_step(3, skip=hot))
    assert ls.tp.migration_pending(skip=hot) == 0
    assert (ls.tp.last_migration_bg_blocks
            == ls.jp.last_migration_bg_blocks > 0)
    mj = ls.jp.finish_migration(live)
    mt = ls.tp.finish_migration(live)
    assert mt == mj is not None
    assert (ls.tp.last_migration_delta_blocks
            == ls.jp.last_migration_delta_blocks > 0)
    _same(ls.jp, ls.tp, {mt[s]: w for s, (w, _) in live.items()})
    assert ls.tp.n_slots == 4 and ls.tp._mig is None
    # the commit adopted the very tensors a staged step was captured on
    assert ls.tp.kv["k"] is staged["k"] and ls.tp.kv["v"] is staged["v"]
    assert ls.tp.decode_cache()["block_tables"] is staged["block_tables"]
    np.testing.assert_array_equal(staged["block_tables"].numpy(),
                                  ls.tp.tables)


def test_undrained_shrink_and_block_size_change_refuse_to_stage():
    setting = _setting(max_batch=3, block_size=8, prefix_share=True)
    ls, live = _populated(setting)
    assert not ls.tp.begin_migration(dict(setting, block_size=16))
    assert ls.tp._mig is None
    assert ls.tp.begin_migration(dict(setting, max_batch=2))
    while ls.tp.migration_pending() > 0:
        ls.tp.migration_step(8)
    assert ls.tp.finish_migration(live) is None      # 3 live > 2 slots
    ls.tp.abort_migration()
    assert ls.tp._mig is None and ls.tp.n_slots == 3
    ls.tp.check_invariants()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("change", [dict(max_batch=4),
                                    dict(cache_dtype="bf16", max_batch=1)])
def test_ssm_relayout_matches_jax(change, arch):
    """The recurrent-state pool (and the hybrid's KV slab, whose slot is
    axis 1 as every leaf's): relayout in lockstep with the JAX pool."""
    cfg = get_config(arch).reduced()
    tcfg = torch_get_config(arch).reduced()
    setting = _setting(max_batch=3, cache_dtype="f32")
    jp = JSSMPool(cfg, setting, max_seq=MAX_SEQ)
    tp = TSSMPool(tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    rng = np.random.default_rng(1)
    for s in range(3):
        assert jp.try_admit(np.zeros(4, np.int32), 4) == tp.try_admit(
            np.zeros(4, np.int32), 4)
        pc = {k: rng.standard_normal((v.shape[0], 1) + v.shape[2:])
              .astype(np.float32) for k, v in jp.state.items()}
        jp.write_prefill(s, {k: jnp.asarray(v) for k, v in pc.items()}, 4)
        tp.write_prefill(s, {k: torch.from_numpy(v) for k, v in pc.items()},
                         4)
    tp.save_state()
    jp.release(1)
    tp.release(1)
    live = {0: (5, 8), 2: (6, 8)}
    new = dict(setting, **change)
    mj = jp.relayout(new, live, min_slots=0)
    mt = tp.relayout(new, live, min_slots=0)
    assert mt == mj and tp.slot_live == jp.slot_live
    assert tp.n_slots == jp.n_slots and tp.exec_key() == jp.exec_key()
    assert tp.last_relayout_blocks == jp.last_relayout_blocks == 2
    assert tp.saved is None                # the snapshot went with the old
    for k in jp.state:
        assert tp.state[k].dtype == (torch.float32 if jp.state[k].dtype
                                     == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(f32(tp.state[k]), f32(jp.state[k]))


def test_relayout_is_a_copy_not_an_alias():
    """The relaid-out pool shares no storage with the old tensors (a step
    captured on the old ones must not see the new pool), and a deep copy
    of a pool relays out independently (the stop-the-world witness the
    staged tests use)."""
    setting = _setting(max_batch=3, block_size=8, prefix_share=True)
    ls, live = _populated(setting)
    old = {k: v for k, v in ls.tp.kv.items()}
    shadow = copy.deepcopy(ls.tp)
    ls.tp.relayout(dict(setting, max_batch=4), live)
    for k in old:
        assert ls.tp.kv[k].data_ptr() != old[k].data_ptr()
    shadow.relayout(dict(setting, max_batch=4), live)
    for k in old:
        assert torch.equal(shadow.kv[k], ls.tp.kv[k])
