"""PyTorch port: RMSNorm and RoPE against the JAX package, elementwise."""
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
