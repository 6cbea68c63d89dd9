"""PyTorch port: the dense LM against the JAX package on the same
parameters (carried over by ``params_from_numpy``) and the same inputs —
prefill, S=1 paged decode and S>1 chunked decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JKnobs
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import ModelKnobs

from _torch_port import LOGIT_TOL, dense_models, f32

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def models():
    return dense_models(0)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_params_from_numpy_is_exact_and_keeps_layout(models):
    cfg, tcfg, jp, tp = models
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        assert tuple(tl[k].shape) == a.shape, k      # (in, out), L leading
        assert tl[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(tl[k]), a.astype(np.float32))


def test_init_params_shapes_and_distribution(models):
    cfg, tcfg, jp, _ = models
    tp = tlm.init_params(tcfg, seed=3, device="cpu")
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        t = f32(tl[k])
        assert t.shape == a.shape, k
        if k[-1] == "scale":
            assert not t.any(), k                    # 1 + scale gain
        else:                                        # trunc normal / sqrt(fan_in)
            fan_in = a.shape[max(0, a.ndim - 2)]
            assert np.abs(t).max() <= 2.0 / np.sqrt(fan_in) + 1e-2, k
            # std of N(0,1) truncated at +-2 is 0.880
            assert abs(t.std() * np.sqrt(fan_in) - 0.880) < 0.05, k
    again = tlm.init_params(tcfg, seed=3, device="cpu")
    assert all(torch.equal(tl[k], v) for k, v in _leaves(again))


@pytest.mark.parametrize("S", [5, 16, 37])
def test_prefill_logits_match_jax(models, S):
    cfg, tcfg, jp, tp = models
    tok = RNG.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, cfg)
    tl, tc = tlm.prefill(tp, torch.from_numpy(tok).long(), tcfg)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert tuple(tc["k"].shape) == jc["k"].shape


def _paged_cache(cfg, bs, n_slots, max_seq, dtype):
    MB = -(-max_seq // bs)
    nb = n_slots * MB + 1
    shape = tlm.init_paged_cache_shapes(cfg, nb, bs)["k"]
    kv = {k: RNG.standard_normal(shape).astype(np.float32) for k in "kv"}
    bt = (np.arange(n_slots * MB).reshape(n_slots, MB) % (nb - 1) + 1
          ).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcache = {k: jnp.asarray(v, jd) for k, v in kv.items()}
    jcache["block_tables"] = jnp.asarray(bt)
    tcache = {k: torch.from_numpy(v).to(td) for k, v in kv.items()}
    tcache["block_tables"] = torch.from_numpy(bt)
    return jcache, tcache, MB


@pytest.mark.parametrize("S,bs,dtype", [
    (1, 8, "float32"), (1, 16, "bfloat16"),       # decode tick
    (5, 8, "float32"), (4, 16, "bfloat16"),       # chunked (suffix prefill)
])
def test_paged_decode_step_matches_jax(models, S, bs, dtype):
    """One decode step over the same paged pool: logits within LOGIT_TOL,
    the step's KV writes land in the same rows (values within a bf16
    step of each other: they come from bf16 activations), and the rest of
    the pool is untouched."""
    cfg, tcfg, jp, tp = models
    n_slots, max_seq = 4, 96
    jcache, tcache, MB = _paged_cache(cfg, bs, n_slots, max_seq, dtype)
    before = f32(tcache["k"]).copy()
    tok = RNG.integers(0, cfg.vocab_size, (n_slots, S)).astype(np.int32)
    pos = np.array([3, 17, 30, 9], np.int32)
    cols = int(pos.max() + S - 1) // bs + 1
    jl, jc = jlm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                             cfg, None, JKnobs(attn_impl="paged",
                                               attn_ctx=cols))
    tl, tc = tlm.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), tcfg,
                             ModelKnobs(attn_impl="paged", attn_ctx=cols))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert tc is tcache                             # written in place
    after, jafter = f32(tc["k"]), f32(jc["k"])
    written = np.any(after != before, axis=(0, 2, 3, 4))
    written[0] = False                              # trash block: never read
    assert written.sum() > 0
    np.testing.assert_array_equal(written[1:],
                                  np.any(jafter != before,
                                         axis=(0, 2, 3, 4))[1:])
    np.testing.assert_allclose(after[:, 1:], jafter[:, 1:], atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("S", [1, 3])
def test_paged_matches_gather_within_port(models, S):
    """attn_impl="paged" against "gather" (dense gather + plain attention)
    on one pool, every context bucket that covers the batch: logits
    within 2e-2 (tests/test_paged_attention.py's bound) and identical
    cache writes."""
    _, tcfg, _, tp = models
    bs, n_slots, max_seq = 8, 4, 96
    _, tcache, MB = _paged_cache(tcfg, bs, n_slots, max_seq, "float32")
    tok = torch.from_numpy(
        RNG.integers(0, tcfg.vocab_size, (n_slots, S))).long()
    pos = torch.tensor([3, 17, 30, 9], dtype=torch.int32)
    base = {k: v.clone() for k, v in tcache.items()}
    lg_g, c_g = tlm.decode_step(tp, {k: v.clone() for k, v in base.items()},
                                tok, pos, tcfg, ModelKnobs(attn_impl="gather"))
    need = (int(pos.max()) + S - 1) // bs + 1
    for cols in [0] + list(range(need, MB + 1)):
        lg_p, c_p = tlm.decode_step(
            tp, {k: v.clone() for k, v in base.items()}, tok, pos, tcfg,
            ModelKnobs(attn_impl="paged", attn_ctx=cols))
        np.testing.assert_allclose(f32(lg_p), f32(lg_g), atol=2e-2,
                                   rtol=2e-2, err_msg=f"cols={cols}")
        for k in ("k", "v"):
            assert torch.equal(c_p[k], c_g[k])


def test_pad_positions_past_the_table_go_to_trash_block(models):
    """Chunked-decode positions past the block table (bucket padding) land
    in physical block 0, never on the last live column."""
    _, tcfg, _, tp = models
    bs, MB, nb = 8, 4, 9
    shape = tlm.init_paged_cache_shapes(tcfg, nb, bs)["k"]
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
             "block_tables": torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)}
    S = 8                                   # positions 28..35; 32.. pad
    tok = torch.from_numpy(RNG.integers(0, tcfg.vocab_size, (1, S))).long()
    tlm.decode_step(tp, cache, tok, torch.tensor([28], dtype=torch.int32),
                    tcfg)
    k = cache["k"]
    assert k[:, 4, 4:].abs().sum() > 0      # real rows 28..31 in block 4
    assert k[:, 0].abs().sum() > 0          # pads 32..35 in the trash block
    assert k[:, 1:4].abs().sum() == 0       # no other block touched
    assert k[:, 4, :4].abs().sum() == 0


def test_params_from_numpy_rejects_missing_cuda(models, monkeypatch):
    cfg, _, jp, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
