"""PyTorch port: ``PagedKVPool`` replays one admit / write / copy-on-write
/ release script in lockstep with the JAX package's pool: equal tables,
refcounts, slot blocks, prefix cache and counters after every step, equal
KV outside the trash block, and ``check_invariants`` on both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro.serving.pool import PagedKVPool as JPool
from repro_torch.configs.registry import get_config as torch_get_config
from repro_torch.serving.pool import PagedKVPool as TPool

from _torch_port import f32


def _same_state(jp: JPool, tp: TPool):
    np.testing.assert_array_equal(tp.tables, jp.tables)
    np.testing.assert_array_equal(tp.ref, jp.ref)
    assert tp.slot_blocks == jp.slot_blocks
    assert tp.slot_live == jp.slot_live
    assert tp.prefix == jp.prefix and tp.block_key == jp.block_key
    assert tp._free == jp._free and tp._reserved == jp._reserved
    for c in ("shared_blocks_hit", "cow_copies", "cache_evictions"):
        assert getattr(tp, c) == getattr(jp, c), c
    assert tp.exec_key() == jp.exec_key()
    assert tp.snapshot() == {k: v for k, v in jp.snapshot().items()}
    for k in ("k", "v"):                 # block 0 is the trash block
        np.testing.assert_array_equal(f32(tp.kv[k])[:, 1:],
                                      f32(jp.kv[k])[:, 1:])
    jp.check_invariants()
    tp.check_invariants()


@pytest.mark.parametrize("cache_dtype,overcommit", [("f32", 1.0),
                                                    ("bf16", 0.6)])
def test_pool_script_matches_jax(cache_dtype, overcommit):
    cfg = get_config("starcoder2-3b").reduced()
    tcfg = torch_get_config("starcoder2-3b").reduced()
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3, block_size=8,
                   prefix_share=True, cache_dtype=cache_dtype,
                   block_overcommit=overcommit)
    jp = JPool(cfg, setting, max_seq=48)
    tp = TPool(tcfg, setting, max_seq=48, device="cpu")
    rng = np.random.default_rng(3)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def admit(prompt, max_new):
        a = jp.try_admit(prompt, max_new)
        b = tp.try_admit(prompt, max_new)
        assert a == b
        _same_state(jp, tp)
        return a

    def write(slot, start, n):
        rows = {k: rng.standard_normal((L, n, K, hd)).astype(np.float32)
                for k in "kv"}
        jp.write_kv(slot, {k: jnp.asarray(v) for k, v in rows.items()}, start)
        tp.write_kv(slot, {k: torch.from_numpy(v) for k, v in rows.items()},
                    start)
        _same_state(jp, tp)

    def cow(slot, start, end):
        jp.prepare_write(slot, start, end)
        tp.prepare_write(slot, start, end)
        _same_state(jp, tp)

    base = rng.integers(0, cfg.vocab_size, (19,)).astype(np.int32)
    slot_a, shared = admit(base, 6)                  # fresh prompt
    assert shared == 0
    write(slot_a, 0, 19)
    tail = rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)
    slot_b, shared = admit(np.concatenate([base[:16], tail]), 4)
    assert shared == 16                              # two shared blocks
    cow(slot_b, 16, 21)
    write(slot_b, 16, 5)
    slot_c, shared = admit(base[:16].copy(), 3)      # whole-prompt match
    assert shared == 15                              # recompute last token
    cow(slot_c, 15, 16)                              # -> copy-on-write
    write(slot_c, 15, 1)
    assert tp.cow_copies == 1
    assert admit(rng.integers(0, cfg.vocab_size, (20,)).astype(np.int32),
                 4) is None                          # no free slot
    for s in (slot_a, slot_b):
        jp.release(s)
        tp.release(s)
        _same_state(jp, tp)
    slot_d, shared = admit(base.copy(), 8)          # served from the cache
    assert shared == 16
    jp.prepare_step_writes([slot_c, slot_d], {slot_c: 16, slot_d: 19})
    tp.prepare_step_writes([slot_c, slot_d], {slot_c: 16, slot_d: 19})
    _same_state(jp, tp)
    for s in (slot_c, slot_d):
        jp.release(s)
        tp.release(s)
    _same_state(jp, tp)
    assert tp.n_active == 0
    assert tp.snapshot()["blocks_held"] == tp.snapshot()[
        "prefix_cached_blocks"]                      # only the cache holds


def test_decode_cache_is_the_pool_in_place():
    tcfg = torch_get_config("starcoder2-3b").reduced()
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=2, block_size=8)
    tp = TPool(tcfg, setting, max_seq=32, device="cpu")
    c = tp.decode_cache()
    assert c["k"] is tp.kv["k"] and c["v"] is tp.kv["v"]
    assert c["block_tables"].dtype == torch.int32
    assert tuple(c["block_tables"].shape) == (2, 4)
    assert tp.kv["k"].dtype == torch.float32          # cache_dtype="f32"
