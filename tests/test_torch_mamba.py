"""PyTorch port, ssm family: the selective scan's plain version (and the
wrapper's CPU dispatch), the causal conv, ``mamba1_block`` in its three
modes and the falcon-mamba LM (prefill on bucket-padded prompts, decode
steps) against the JAX package on the same parameters and inputs, plus
the port's own decode-vs-prefill agreement.

Inputs are drawn with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import selective_scan as j_scan
from repro.kernels.mamba_scan import selective_scan_ref as j_scan_ref
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba

from _torch_port import LOGIT_TOL, f32, ssm_models

RNG = np.random.default_rng(12)
T = torch.from_numpy
# f32 scan, plain version against the Pallas kernel or the JAX oracle: the
# same f32 operations in another order (exp, the state update and the
# <h, C> reduction round differently) — f32 rounding over <= 96 steps of a
# contracting recurrence, the bound tests/test_kernels.py holds the Pallas
# kernel to in f32.
SCAN_TOL = 1e-4
# Activations of the reduced model are bf16 (one step is 2^-8 relative):
# XLA and PyTorch round the bf16 silu, softplus and conv sums at different
# places.  One block's outputs (|out| < 0.2) and state h (|h| < 0.9) then
# differ by up to 1.5e-3 and 3.3e-3 (measured over seeded inputs): bound
# 1e-2.  Through the two-layer model, conv windows (bf16 activations,
# |x| < 2) and states differ by up to 0.018, two bf16 steps: bound 4/128.
BLOCK_TOL = 1e-2
BF16_TOL = 4 / 128


@pytest.fixture(scope="module")
def models():
    return ssm_models(0)


def _scan_inputs(B, S, D, N, dtype=np.float32, h0=False):
    """x, dt, Bm, Cm in ``dtype`` (bf16 inputs rounded once, in numpy's
    f32 -> jnp bf16), A f32 and negative, dt in (0, ~0.3)."""
    x = RNG.standard_normal((B, S, D)).astype(np.float32)
    dt = np.abs(RNG.standard_normal((B, S, D))).astype(np.float32) * 0.1
    Bm = RNG.standard_normal((B, S, N)).astype(np.float32)
    Cm = RNG.standard_normal((B, S, N)).astype(np.float32)
    A = -np.abs(RNG.standard_normal((D, N))).astype(np.float32) - 0.1
    hz = RNG.standard_normal((B, D, N)).astype(np.float32) if h0 else None
    if dtype != np.float32:
        x, dt, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                         for a in (x, dt, Bm, Cm))
    return x, dt, Bm, Cm, A, hz


def _port_scan(fn, x, dt, Bm, Cm, A, h0, bf16):
    """The port's scan with x and dt in bf16 or f32 (the kernel's input
    types) and Bm, Cm, A, h0 in f32 (its contract)."""
    dt_ = torch.bfloat16 if bf16 else torch.float32
    return fn(T(x).to(dt_), T(dt).to(dt_), T(Bm), T(Cm), T(A),
              None if h0 is None else T(h0))


@pytest.mark.parametrize("B,S,D,N,chunk,bd", [
    (1, 32, 64, 8, 8, 64),
    (2, 64, 128, 16, 16, 64),
    (2, 96, 64, 4, 32, 32),     # chunk not dividing S -> auto-halved
])
@pytest.mark.parametrize("bf16", [False, True])
def test_scan_plain_matches_pallas(B, S, D, N, chunk, bd, bf16):
    """No h0: the plain version and the wrapper's CPU dispatch against the
    Pallas kernel in interpret mode (tests/test_kernels.py's shapes)."""
    x, dt, Bm, Cm, A, _ = _scan_inputs(B, S, D, N,
                                       "bf16" if bf16 else np.float32)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    y, h = j_scan(jnp.asarray(x, jt), jnp.asarray(dt, jt),
                  jnp.asarray(Bm, jt), jnp.asarray(Cm, jt), jnp.asarray(A),
                  chunk=chunk, block_d=bd, interpret=True)
    n0 = LAUNCHES["selective_scan"]
    for fn in (selective_scan_ref, selective_scan):
        ty, th = _port_scan(fn, x, dt, Bm, Cm, A, None, bf16)
        assert ty.dtype == th.dtype == torch.float32
        np.testing.assert_allclose(f32(ty), f32(y), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)
        np.testing.assert_allclose(f32(th), f32(h), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)
    assert LAUNCHES["selective_scan"] == n0     # CPU: no kernel launched


@pytest.mark.parametrize("S", [1, 5, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_scan_from_h0_matches_jax_ref(S, bf16):
    """From a stored state h0 (decode, S = 1 and S > 1): against the JAX
    oracle, which takes h0 (the Pallas kernel does not)."""
    B, D, N = 3, 64, 16
    x, dt, Bm, Cm, A, h0 = _scan_inputs(B, S, D, N,
                                        "bf16" if bf16 else np.float32,
                                        h0=True)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    y, h = j_scan_ref(jnp.asarray(x, jt), jnp.asarray(dt, jt),
                      jnp.asarray(Bm), jnp.asarray(Cm), jnp.asarray(A),
                      h0=jnp.asarray(h0))
    for fn in (selective_scan_ref, selective_scan):
        ty, th = _port_scan(fn, x, dt, Bm, Cm, A, h0, bf16)
        np.testing.assert_allclose(f32(ty), f32(y), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)
        np.testing.assert_allclose(f32(th), f32(h), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)


def test_scan_writes_h_out_in_place_and_zero_dt_is_identity():
    """``h_out=h0`` updates the state tensor itself; steps with dt = 0
    (the model's right padding) leave the state exactly as it was."""
    x, dt, Bm, Cm, A, h0 = _scan_inputs(2, 6, 32, 8, h0=True)
    dt[:, 3:] = 0.0
    hs = T(h0.copy())
    y, h = selective_scan(T(x), T(dt), T(Bm), T(Cm), T(A), hs, h_out=hs)
    assert h is hs
    _, h3 = selective_scan_ref(T(x[:, :3]), T(dt[:, :3]), T(Bm[:, :3]),
                               T(Cm[:, :3]), T(A), T(h0))
    assert torch.equal(hs, h3)
    assert y.shape == (2, 6, 32)


@pytest.mark.parametrize("S,with_state,valid_len", [
    (8, False, None), (8, True, None), (1, True, None), (3, True, None),
    (8, False, 5), (8, False, 1), (8, False, 2), (8, False, 3), (3, False, 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(S, with_state, valid_len, dtype):
    """Output and the returned window; prompts of 1-3 tokens (shorter than
    the K = 4 window) reach into the zero or stored past."""
    B, Di, K = 2, 16, 4
    x = RNG.standard_normal((B, S, Di)).astype(np.float32)
    w = RNG.standard_normal((Di, K)).astype(np.float32)
    b = RNG.standard_normal((Di,)).astype(np.float32)
    st = (RNG.standard_normal((B, Di, K - 1)).astype(np.float32)
          if with_state else None)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jw = jmamba._causal_conv1d(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
        None if st is None else jnp.asarray(st, jd), valid_len)
    ty, tw = tmamba._causal_conv1d(
        T(x).to(td), T(w).to(td), T(b).to(td),
        None if st is None else T(st).to(td), valid_len)
    assert tuple(tw.shape) == jw.shape == (B, Di, K - 1)
    # f32: the same four products and sums; bf16: see BF16_TOL
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(f32(ty), f32(jy), atol=tol, rtol=tol)
    np.testing.assert_array_equal(f32(tw), f32(jw))   # a copy of inputs


def _layer0(models):
    cfg, tcfg, jp, tp = models
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    return cfg, tcfg, jl, tl


@pytest.mark.parametrize("mode,S,valid_len", [
    ("full", 8, None),          # prefill from zeros
    ("full", 8, 5),             # right-padded prefill
    ("decode", 1, None),        # one token from the stored state
    ("decode", 4, None),        # several tokens from the stored state
])
def test_mamba1_block_modes_match_jax(models, mode, S, valid_len):
    cfg, tcfg, jl, tl = _layer0(models)
    B, D, Di, N, K = 2, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    x = RNG.standard_normal((B, S, D)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = T(x).to(torch.bfloat16)
    jst = tst = None
    if mode == "decode":
        conv = np.asarray(jnp.asarray(
            RNG.standard_normal((B, Di, K - 1)), jnp.bfloat16), np.float32)
        h = RNG.standard_normal((B, Di, N)).astype(np.float32) * 0.5
        jst = {"conv": jnp.asarray(conv, jnp.bfloat16), "h": jnp.asarray(h)}
        tst = {"conv": T(conv).to(torch.bfloat16), "h": T(h.copy())}
    jo, jn = jmamba.mamba1_block(jx, jl, cfg, state=jst, valid_len=valid_len)
    to, tn = tmamba.mamba1_block(tx, tl, tcfg, state=tst,
                                 valid_len=valid_len)
    if mode == "decode":
        assert tn is tst                            # written in place
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(to), f32(jo), atol=BLOCK_TOL, rtol=0)
    # conv window: copies of bf16 activations (equal up to their rounding)
    np.testing.assert_allclose(f32(tn["conv"]), f32(jn["conv"]),
                               atol=BF16_TOL, rtol=0)
    assert tn["h"].dtype == torch.float32
    np.testing.assert_allclose(f32(tn["h"]), f32(jn["h"]), atol=BLOCK_TOL,
                               rtol=0)


@pytest.mark.parametrize("S,with_state,valid_len", [
    (1, True, None), (8, False, 5)])
def test_mamba1_block_hands_the_scan_its_inputs_where_they_lie(
        models, monkeypatch, S, with_state, valid_len):
    """The block passes dt in bf16 and Bm, Cm as bf16 views of the x_proj
    output (no cast, no copy), with dt zeroed past ``valid_len`` in bf16."""
    cfg, tcfg, _, tl = _layer0(models)
    B, Di, N, R = 2, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    seen, scan = {}, tmamba.selective_scan

    def spy(x, dt, Bm, Cm, A, h0=None, *, h_out=None):
        seen.update(dt=dt, Bm=Bm, Cm=Cm)
        return scan(x, dt, Bm, Cm, A, h0, h_out=h_out)

    monkeypatch.setattr(tmamba, "selective_scan", spy)
    x = T(RNG.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    st = (tmamba.init_mamba_state(tcfg, B, dtype=torch.bfloat16)
          if with_state else None)
    tmamba.mamba1_block(x.to(torch.bfloat16), tl, tcfg, state=st,
                        valid_len=valid_len)
    dt, Bm, Cm = seen["dt"], seen["Bm"], seen["Cm"]
    assert dt.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
    assert Bm.shape == Cm.shape == (B, S, N)
    assert Bm.stride() == Cm.stride() == (S * (R + 2 * N), R + 2 * N, 1)
    assert Cm.data_ptr() - Bm.data_ptr() == N * Bm.element_size()
    if valid_len is not None:
        assert not dt[:, valid_len:].any() and dt[:, :valid_len].all()


def test_decode_from_init_mamba_state_is_the_full_sequence_mode(models):
    """``mamba1_block`` decoding S tokens from ``init_mamba_state`` (zeros)
    is its full-sequence mode: the same output and state, bit for bit."""
    _, _, _, tl = _layer0(models)
    tcfg = models[1]
    x = T(RNG.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
          ).to(torch.bfloat16)
    st = tmamba.init_mamba_state(tcfg, 2, dtype=torch.bfloat16)
    assert st["h"].dtype == torch.float32
    out_d, st_d = tmamba.mamba1_block(x, tl, tcfg, state=st)
    out_f, st_f = tmamba.mamba1_block(x, tl, tcfg)
    assert torch.equal(out_d, out_f)
    assert all(torch.equal(st_d[k], st_f[k]) for k in ("conv", "h"))


def test_mamba2_block_hands_the_scan_its_f32_inputs(monkeypatch):
    """The mamba2 recurrence through the same scan at decode: x f32, dt a
    head's value repeated over its P channels, Bm and Cm f32 views of one
    projection (last stride 1), A a head's scalar over (P, N), and h0 the
    state's (B, nh, P, N) viewed as (B, Di, N), written in place; the
    block's output and state agree with the JAX block (one bf16 step, and
    f32 summation order: tests/test_torch_hybrid.py's bounds)."""
    from _torch_port import hybrid_models
    cfg, tcfg, jp, tp = hybrid_models(0)
    B, S, Di, N = 2, 3, cfg.d_inner, cfg.ssm_state
    nh, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    seen, scan = {}, tmamba.selective_scan

    def spy(x, dt, Bm, Cm, A, h0=None, *, h_out=None):
        seen.update(x=x, dt=dt, Bm=Bm, Cm=Cm, A=A, h0=h0, h_out=h_out)
        return scan(x, dt, Bm, Cm, A, h0, h_out=h_out)

    monkeypatch.setattr(tmamba, "selective_scan", spy)
    x = RNG.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv = f32(jnp.asarray(RNG.standard_normal((B, Di, 3)), jnp.bfloat16))
    h = RNG.standard_normal((B, nh, P, N)).astype(np.float32) * 0.3
    tst = {"conv": T(conv).to(torch.bfloat16), "h": T(h.copy())}
    to, tn = tmamba.mamba2_block(T(x).to(torch.bfloat16), tl, tcfg,
                                 state=tst)
    assert all(seen[k].dtype == torch.float32
               for k in ("x", "dt", "Bm", "Cm", "A"))
    assert seen["x"].is_contiguous() and seen["dt"].is_contiguous()
    dt = seen["dt"].reshape(B, S, nh, P)
    assert torch.equal(dt, dt[..., :1].expand(B, S, nh, P))
    A = seen["A"].reshape(nh, P, N)
    assert torch.equal(A, A[:, :1, :1].expand(nh, P, N))
    assert seen["Bm"].stride()[2] == 1 and seen["Bm"].shape == (B, S, N)
    assert seen["Cm"].data_ptr() - seen["Bm"].data_ptr() == N * 4
    assert seen["h0"] is seen["h_out"]
    assert seen["h0"].data_ptr() == tst["h"].data_ptr() and tn is tst
    jo, jn = jmamba.mamba2_block(jnp.asarray(x, jnp.bfloat16), jl, cfg,
                                 state={"conv": jnp.asarray(conv,
                                                            jnp.bfloat16),
                                        "h": jnp.asarray(h)})
    np.testing.assert_allclose(f32(to), f32(jo), rtol=2 ** -7,
                               atol=2 ** -10)
    np.testing.assert_allclose(f32(tn["h"]), f32(jn["h"]), atol=1e-6,
                               rtol=0)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_params_from_numpy_carries_the_ssm_tree(models):
    """Same keys, stacked on L, (in, out) layout, values exact."""
    cfg, tcfg, jp, tp = models
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    assert ("layers", "ssm", "x_proj") in tl
    for k, a in jl.items():
        assert tuple(tl[k].shape) == a.shape, k
        assert tl[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(tl[k]), a.astype(np.float32))
    shapes = dict(_leaves(tlm.param_shapes(tcfg)))
    assert {k: tuple(v.shape) for k, v in tl.items()} == shapes


def test_init_params_ssm_fixups(models):
    """The port's own init: the JAX tree's shapes, its fix-ups exactly
    (A_log = log(1..N), Dskip = 1, conv_b, dt_b and norm scales zero) and
    its truncated-normal distribution elsewhere."""
    cfg, tcfg, jp, _ = models
    tp = tlm.init_params(tcfg, seed=3, device="cpu")
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for k, t in _leaves(tp):
        a = jl[k].astype(np.float32)
        t = f32(t)
        assert t.shape == a.shape, k
        if k[-1] in ("A_log", "Dskip", "conv_b", "dt_b", "scale"):
            np.testing.assert_array_equal(t, a, err_msg=str(k))
        else:
            fan_in = a.shape[max(0, a.ndim - 2)]
            assert np.abs(t).max() <= 2.0 / np.sqrt(fan_in) + 1e-2, k


def _padded(prompt, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(prompt)] = prompt
    return out


@pytest.mark.parametrize("P", [1, 2, 3, 7, 13, 16])
def test_prefill_on_padded_prompts_matches_jax(models, P):
    """The engine's prefill: a prompt right-padded to the 16-token bucket
    with ``valid_len = P``.  Logits at token P-1 within LOGIT_TOL, the
    state after token P (not after the pads) within BF16_TOL, and equal to
    the state of the unpadded prompt."""
    cfg, tcfg, jp, tp = models
    prompt = RNG.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
    tok = _padded(prompt, 16)
    jh, _, jc = jlm.forward(jp, {"tokens": jnp.asarray(tok)}, cfg,
                            mode="prefill", valid_len=P)
    th, tc = tlm.forward(tp, T(tok).long(), tcfg, mode="prefill",
                         valid_len=P)
    jlg = jlm.logits_fn(jp, jh[:, P - 1:P], cfg)
    tlg = tlm.logits_fn(tp, th[:, P - 1:P], tcfg)
    np.testing.assert_allclose(f32(tlg), f32(jlg), atol=LOGIT_TOL, rtol=0)
    assert tuple(tc["conv"].shape) == jc["conv"].shape
    assert tc["h"].dtype == torch.float32
    for k in ("conv", "h"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), atol=BF16_TOL,
                                   rtol=0, err_msg=k)
    _, tc_exact = tlm.forward(tp, T(tok[:, :P]).long(), tcfg, mode="prefill")
    for k in ("conv", "h"):
        torch.testing.assert_close(tc[k], tc_exact[k], atol=1e-6, rtol=0)


def test_decode_steps_match_jax(models):
    """From one stored state (the JAX prefill's, handed to both), a run of
    S = 1 decode steps and one S = 3 step: logits within LOGIT_TOL at every
    step, the port's cache written in place, final state within
    BF16_TOL."""
    cfg, tcfg, jp, tp = models
    B = 3
    tok = RNG.integers(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    _, _, jc = jlm.forward(jp, {"tokens": jnp.asarray(tok)}, cfg,
                           mode="prefill")
    tc = {"conv": T(np.asarray(jc["conv"], np.float32)).to(torch.bfloat16),
          "h": T(np.array(jc["h"], np.float32))}
    pos = np.full((B,), 9, np.int32)
    for step, S in enumerate([1, 1, 3, 1]):
        nt = RNG.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(nt), jnp.asarray(pos),
                                 cfg)
        tl, tc2 = tlm.decode_step(tp, tc, T(nt).long(), T(pos), tcfg)
        assert tc2 is tc
        np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {step}")
        pos = pos + S
    for k in ("conv", "h"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), atol=BF16_TOL,
                                   rtol=0, err_msg=k)


def test_decode_matches_prefill_within_port(models):
    """The port against itself (tests/test_moe_models.py's
    test_mamba_decode_matches_scan): token-by-token decode from a zero
    state reproduces the full-sequence prefill's last logits within
    LOGIT_TOL (the two differ only in matmul row counts)."""
    _, tcfg, _, tp = models
    B, S = 2, 12
    tok = T(RNG.integers(0, tcfg.vocab_size, (B, S))).long()
    full, _ = tlm.prefill(tp, tok, tcfg)
    shapes = tlm.init_cache_shapes(tcfg, B)
    cache = {"conv": torch.zeros(shapes["conv"], dtype=torch.bfloat16),
             "h": torch.zeros(shapes["h"])}
    for t in range(S):
        lg, cache = tlm.decode_step(tp, cache, tok[:, t:t + 1],
                                    torch.full((B,), t, dtype=torch.int32),
                                    tcfg)
    np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, -1]),
                               atol=LOGIT_TOL, rtol=0)
    _, pc = tlm.prefill(tp, tok, tcfg)
    torch.testing.assert_close(cache["h"], pc["h"], atol=BF16_TOL, rtol=0)
