"""Plain PyTorch version of blockwise int8 quantization (the JAX package's
``quant/ref.py``): bit-exact against the CUDA kernel for equal uniforms."""
from __future__ import annotations

import torch


def quantize_ref(x, rand_u01, block: int = 256):
    """x: (n,) f32 or bf16 (n % block == 0; bf16 is widened, exactly);
    rand_u01: (n,) uniforms in [0, 1), or one value expanded to (n,).

    Per-block symmetric int8 with stochastic rounding (unbiased).
    Returns (q: (n,) int8, scales: (n//block,) f32).
    """
    n = x.shape[0]
    xb = x.reshape(n // block, block).float()
    rb = rand_u01.reshape(n // block, block)
    amax = torch.clamp(xb.abs().amax(dim=1), min=1e-12)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal on CUDA, which is not bit-exact
    scale = amax / torch.full_like(amax, 127.0)
    scaled = xb / scale[:, None]
    lo = torch.floor(scaled)
    q = lo + (rb < (scaled - lo)).float()
    q = torch.clamp(q, -127, 127)
    return q.reshape(n).to(torch.int8), scale


def dequantize_ref(q, scales, block: int = 256, out_dtype=torch.float32):
    """q * scale in f32, then rounded to ``out_dtype``."""
    nb = scales.shape[0]
    x = (q.reshape(nb, block).float() * scales[:, None]).reshape(-1)
    return x.to(out_dtype)
