"""PyTorch port: the plain versions of the CUDA kernels against the JAX
package's Pallas kernels (interpret mode) and their oracles.

On the CPU every kernel wrapper runs its plain version, so these tests pin
the arithmetic that ``chip_smoke.py`` and ``test_torch_cuda.py`` then hold
the CUDA kernels to on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline: fixed-seed fallback shim
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.paged_attention import paged_attention_ref as j_paged_ref
from repro.kernels.quant import dequantize as j_dequantize
from repro.kernels.quant import dequantize_ref as j_dequantize_ref
from repro.kernels.quant import quantize as j_quantize
from repro.kernels.quant import quantize_ref as j_quantize_ref
from repro.models.attention import paged_decode_attention as j_paged_decode
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.quant import (dequantize, dequantize_ref, quantize,
                                       quantize_ref)
from repro_torch.models.attention import paged_decode_attention

from _torch_port import f32

RNG = np.random.default_rng(11)
T = torch.from_numpy


def _paged_case(B, S, H, K, hd, bs, MB, pos=None, shared=False):
    NB = B * MB + 3
    q = RNG.standard_normal((B, S, H, hd)).astype(np.float32)
    kp = RNG.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = RNG.standard_normal((NB, bs, K, hd)).astype(np.float32)
    bt = RNG.integers(0, NB, (B, MB)).astype(np.int32)
    if shared:                      # every request aliases request 0's prefix
        bt[:, :MB // 2] = bt[0, :MB // 2]
    if pos is None:
        pos = RNG.integers(0, MB * bs - S, (B,))
    return q, kp, vp, bt, np.asarray(pos, np.int32)


@pytest.mark.parametrize("B,S,H,K,hd,bs,MB,shared", [
    (2, 1, 4, 2, 16, 8, 6, False),     # single-token decode, GQA
    (1, 1, 8, 2, 64, 16, 5, False),    # G = 4, bigger blocks
    (3, 5, 4, 2, 16, 8, 6, False),     # multi-token chunked decode
    (2, 7, 6, 2, 32, 16, 6, True),     # chunk not dividing bs, shared table
])
def test_paged_plain_matches_pallas(B, S, H, K, hd, bs, MB, shared):
    """f32 throughout: plain version == Pallas kernel == JAX oracle within
    2e-5 (summation order only)."""
    q, kp, vp, bt, pos = _paged_case(B, S, H, K, hd, bs, MB, shared=shared)
    ker = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(bt), jnp.asarray(pos), interpret=True)
    ref = j_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(bt), jnp.asarray(pos))
    out = paged_attention(T(q), T(kp), T(vp), T(bt), T(pos))
    np.testing.assert_allclose(f32(out), f32(ker), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5, rtol=2e-5)


def test_paged_tail_positions_and_ctx_cols():
    """Every fill of the last live block across a block boundary, with the
    visible prefix cut to the columns the position needs (the engine's
    context bucket): the port's wrapper, the port's model path and the
    JAX model path agree with the JAX oracle over the full table."""
    B, S, H, K, hd, bs, MB = 1, 1, 4, 2, 16, 8, 4
    for p in list(range(0, 2 * bs + 1)) + [MB * bs - 2]:
        q, kp, vp, bt, pos = _paged_case(B, S, H, K, hd, bs, MB, pos=[p])
        cols = p // bs + 1
        ref = f32(j_paged_ref(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(bt),
                              jnp.asarray(pos)))
        ker = paged_attention(T(q), T(kp), T(vp), T(bt), T(pos),
                              ctx_cols=cols)
        mdl = paged_decode_attention(T(q), T(kp), T(vp), T(bt), pos=T(pos),
                                     ctx_cols=cols)
        jm = j_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(bt), pos=jnp.asarray(pos),
                            ctx_cols=cols)
        np.testing.assert_allclose(f32(ker), ref, atol=2e-5, rtol=2e-5,
                                   err_msg=f"pos={p}")
        # the model path casts q to bf16 (as the JAX model path does)
        np.testing.assert_allclose(f32(mdl), f32(jm), atol=2e-5, rtol=2e-5,
                                   err_msg=f"pos={p}")


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_model_path_matches_jax_model_path(pool_dtype):
    """The port's CPU decode schedule (q in bf16, p rounded to the pool
    dtype) against the JAX package's, at bf16 q: equal within 2e-5 for an
    f32 pool, and within one bf16 step of the bf16 output for a bf16 pool
    (the two frameworks may round p differently on a tie)."""
    q, kp, vp, bt, pos = _paged_case(3, 4, 4, 2, 16, 8, 6)
    jd, td = getattr(jnp, pool_dtype), getattr(torch, pool_dtype)
    jq = jnp.asarray(q, jnp.bfloat16)
    a = j_paged_decode(jq, jnp.asarray(kp, jd), jnp.asarray(vp, jd),
                       jnp.asarray(bt), pos=jnp.asarray(pos))
    b = paged_decode_attention(T(q).bfloat16(), T(kp).to(td), T(vp).to(td),
                               T(bt), pos=T(pos))
    tol = 2e-5 if pool_dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(f32(b), f32(a), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [
    (1, 32, 32, 4, 2, 16),     # powers of two
    (2, 24, 24, 6, 2, 32),     # not a power of two
    (1, 40, 40, 4, 1, 16),     # not a power of two, MQA
])
def test_flash_plain_matches_pallas(B, Sq, Skv, H, K, hd):
    """f32 inputs: the plain version (GQA inside) against the Pallas
    kernel (interpret mode; it halves its blocks to divide the lengths)
    within 2e-5."""
    q = RNG.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = RNG.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = RNG.standard_normal((B, Skv, K, hd)).astype(np.float32)
    ker = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=16, block_k=16, interpret=True)
    out = flash_attention(T(q), T(k), T(v), block_k=16)
    np.testing.assert_allclose(f32(out), f32(ker), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Sq,Skv", [(13, 13), (7, 29), (37, 37)])
def test_flash_plain_matches_oracle_ragged(Sq, Skv):
    """Ragged lengths and q aligned to the end of kv (default positions):
    the plain version against the JAX oracle on head-expanded kv, f32
    within 2e-5, and explicit positions equal to the defaults."""
    H, K, hd = 4, 2, 16
    q = RNG.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = RNG.standard_normal((2, Skv, K, hd)).astype(np.float32)
    v = RNG.standard_normal((2, Skv, K, hd)).astype(np.float32)
    ref = j_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 2),
                          jnp.repeat(jnp.asarray(v), 2, 2))
    out = attention_ref(T(q), T(k), T(v))
    pos_out = attention_ref(T(q), T(k), T(v),
                            torch.arange(Sq) + (Skv - Sq), torch.arange(Skv))
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(f32(pos_out), f32(out))


@pytest.mark.parametrize("nb,block", [(4, 256), (7, 32), (3, 128)])
def test_quant_bit_exact_against_pallas(nb, block):
    x = (RNG.standard_normal(nb * block) * 3).astype(np.float32)
    u = RNG.random(nb * block).astype(np.float32)
    jq, js = j_quantize(jnp.asarray(x), jnp.asarray(u), block=block,
                        interpret=True)
    q, s = quantize(T(x), T(u), block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jx = j_dequantize(jq, js, block=block, interpret=True)
    np.testing.assert_array_equal(dequantize(q, s, block=block).numpy(),
                                  np.asarray(jx))


@settings(max_examples=25, deadline=None)
@given(nb=st.integers(1, 6), log_scale=st.floats(-6.0, 6.0),
       seed=st.integers(0, 2 ** 31 - 1), half=st.booleans())
def test_quant_property_bit_exact(nb, log_scale, seed, half):
    """Any magnitude, with the engine's deterministic u = 0.5 or random
    uniforms: quantize and dequantize are bit-exact against the JAX
    oracle."""
    rng = np.random.default_rng(seed)
    n = nb * 64
    x = (rng.standard_normal(n) * 10.0 ** log_scale).astype(np.float32)
    u = (np.full(n, 0.5, np.float32) if half
         else rng.random(n).astype(np.float32))
    jq, js = j_quantize_ref(jnp.asarray(x), jnp.asarray(u), block=64)
    q, s = quantize_ref(T(x), T(u), block=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_ref(q, s, block=64).numpy(),
        np.asarray(j_dequantize_ref(jq, js, block=64)))


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing, so its launch counter stays put."""
    before = dict(LAUNCHES)
    q, kp, vp, bt, pos = _paged_case(2, 1, 4, 2, 16, 8, 4)
    np.testing.assert_array_equal(
        f32(paged_attention(T(q), T(kp), T(vp), T(bt), T(pos))),
        f32(paged_attention_ref(T(q), T(kp), T(vp), T(bt), T(pos))))
    x = T(RNG.standard_normal((1, 8, 4, 16)).astype(np.float32))
    kv = T(RNG.standard_normal((1, 8, 2, 16)).astype(np.float32))
    np.testing.assert_array_equal(f32(flash_attention(x, kv, kv)),
                                  f32(attention_ref(x, kv, kv)))
    xq = T(RNG.standard_normal(64).astype(np.float32))
    u = torch.full((64,), 0.5)
    qq, ss = quantize(xq, u, block=32)
    rq, rs = quantize_ref(xq, u, block=32)
    assert torch.equal(qq, rq) and torch.equal(ss, rs)
    assert torch.equal(dequantize(qq, ss, block=32),
                       dequantize_ref(rq, rs, block=32))
    assert dict(LAUNCHES) == before
