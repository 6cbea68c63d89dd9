"""PyTorch port: RMSNorm, RoPE, silu and softplus against the JAX package,
elementwise, and the blocks the silu feeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc

from _torch_port import f32


def test_rope_freqs_bit_identical():
    for hd, theta in [(16, 1e5), (128, 1e5), (128, 1e6), (64, 1e4)]:
        a, b = jc.rope_freqs(hd, theta), tc.rope_freqs(hd, theta)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal((64,)).astype(np.float32) * 0.1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a = jc.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    b = tc.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(scale).to(td))
    # f32: rsqrt implementations differ by an ulp; bf16: one rounding
    # of the same f32 value, so at most one bf16 step on a rare tie
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(f32(b), f32(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_apply_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 9, 4, 16
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 1000, (B, S))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a = jc.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), theta)
    b = tc.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), theta)
    # f32 cos/sin of angles up to ~1000 rad differ by a few ulps between
    # XLA and PyTorch; bf16 rounds that once (one bf16 step at |x| < 4)
    tol = 2e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(f32(b), f32(a), rtol=tol, atol=tol)


def _wide_inputs(dtype):
    """2^20 normal(0, 4) values in ``dtype`` (both packages get the same
    rounded values), plus the edges: zeros, +-inf-bound magnitudes."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(1 << 20) * 4).astype(np.float32)
    x[:6] = [0.0, -0.0, 80.0, -80.0, 1e-30, -1e-30]
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(f32(jx))).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_rounds_like_jax(dtype):
    """``common.silu`` is ``jax.nn.silu`` op by op in x's dtype: bit for bit
    on bf16 inputs (``F.silu`` differs from it on ~37% of them, ROADMAP
    C11).  On f32 inputs the two libraries' f32 exp differ in the last
    bits (XLA's CPU exp and PyTorch's are other approximations), so the
    same chain agrees within 3 ulps (measured), bound 4 ulps."""
    jx, tx = _wide_inputs(dtype)
    want = f32(jax.nn.silu(jx))
    got = f32(tc.silu(tx))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        assert (f32(torch.nn.functional.silu(tx)) != want).mean() > 0.3
    else:
        np.testing.assert_allclose(got, want, rtol=4 * 2 ** -23, atol=1e-37)


def test_softplus_rounds_like_jax():
    """``common.softplus`` is ``jax.nn.softplus`` op by op: bit for bit on
    bf16 inputs (``F.softplus`` differs on ~15% of them)."""
    jx, tx = _wide_inputs("bfloat16")
    np.testing.assert_array_equal(f32(tc.softplus(tx)),
                                  f32(jax.nn.softplus(jx)))


def test_mlp_and_mamba1_block_match_jax_on_bf16():
    """The two blocks the silu feeds, on the same bf16 inputs and weights:
    the JAX ``_mlp_apply`` and ``mamba1_block`` within one bf16 step, and
    equal but where XLA and PyTorch block a bf16 matrix product
    differently (measured over 4 seeds x 3 lengths: at most 0.22% of the
    MLP's outputs and 0.78% of the block's differ): at most 2%."""
    from repro.models import lm as jlm
    from repro.models import mamba as jm
    from repro_torch.models import lm as tlm
    from repro_torch.models import mamba as tm

    from _torch_port import dense_models, ssm_models
    checks = []
    _, _, jp, tp = dense_models(0)
    scfg, tcfg, sjp, stp = ssm_models(0)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        for S in (1, 7, 33):
            x = jnp.asarray(rng.standard_normal((2, S, 64)) * 2, jnp.bfloat16)
            tx = torch.from_numpy(f32(x)).to(torch.bfloat16)
            i = seed % 2
            lp = jax.tree_util.tree_map(lambda t: t[i], jp["layers"]["mlp"])
            tlp = {k: v[i] for k, v in tp["layers"]["mlp"].items()}
            checks.append((f32(jlm._mlp_apply(x, lp, jnp.bfloat16)),
                           f32(tlm._mlp_apply(tx, tlp))))
            sp = jax.tree_util.tree_map(lambda t: t[i], sjp["layers"]["ssm"])
            tsp = {k: v[i] for k, v in stp["layers"]["ssm"].items()}
            checks.append((f32(jm.mamba1_block(x / 2, sp, scfg)[0]),
                           f32(tm.mamba1_block(tx / 2, tsp, tcfg)[0])))
    for want, got in checks:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -10)
        assert (got != want).mean() <= 0.02


def test_silu_gradient_rounds_like_jax():
    """The gradient of ``common.silu`` is JAX's derivative of
    ``jax.nn.silu`` op by op in bf16: bit for bit."""
    jx, tx = _wide_inputs("bfloat16")
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.standard_normal(jx.shape), jnp.bfloat16)
    want = f32(jax.vjp(jax.nn.silu, jx)[1](g)[0])
    tx = tx.clone().requires_grad_()
    (got,) = torch.autograd.grad(tc.silu(tx), tx,
                                 torch.from_numpy(np.array(f32(g))).to(
                                     torch.bfloat16))
    np.testing.assert_array_equal(f32(got), want)
