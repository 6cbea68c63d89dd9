"""Gradient push compression (the paper's ``enable_bfloat16_sendrecv``
knob, generalized; the JAX package's ``ps/compression.py``).

``bf16``  cast the pushed gradient to bfloat16 and back.
``int8``  per-tensor symmetric int8 with stochastic rounding (unbiased):
          each gradient leaf is one block of the port's int8 kernels
          (``kernels.quant``: ``quantize`` at ``block = g.numel()``, then
          ``dequantize`` back to the gradient's dtype), with uniforms drawn
          on the leaf's device from a ``torch.Generator`` seeded by (17,
          step, leaf index).  The JAX package draws them from
          ``fold_in(PRNGKey(17), step)`` split per leaf; the two streams
          differ, so a test hands both the same uniforms (``uniforms``).

The numerics are applied for real (they change statistical efficiency and
the tuner must see that); the bandwidth saving enters the cost model
through ``compressed_bytes_per_push``.  The port compresses **in
place**: each leaf's result is written back into its gradient tensor, one
leaf at a time, and the leaf's uniforms and int8 copy are freed before the
next (at full width the largest leaf's u is 4.5 GB and its q 1.1 GB), so
the push never holds a second copy of the gradients.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves
from repro_torch.kernels.quant import dequantize, quantize

SEED_BASE = 17


def leaf_seed(step: int, index: int) -> int:
    """The generator seed of leaf ``index``'s uniforms at ``step``."""
    return (SEED_BASE * 1_000_003 + step) * 1_000_003 + index


def quantize_dequantize_int8(g, u):
    """``g`` as one int8 block with stochastic rounding by ``u`` (f32,
    g's shape), dequantized to g's dtype."""
    flat = g.reshape(-1)
    n = flat.numel()
    q, scale = quantize(flat, u.reshape(-1), block=n)
    return dequantize(q, scale, block=n, out_dtype=g.dtype).view(g.shape)


@torch.no_grad()
def compress_grads(grads, mode: str, step, uniforms=None):
    """``grads`` (nested dict of tensors) as pushed under ``mode``: none |
    bf16 | int8, written in place; returns ``grads``.  ``step`` is the
    host step count (int) or a 0-dim tensor (read once, for int8);
    ``uniforms`` optionally gives int8's draws as a tree of f32 tensors
    shaped like ``grads``."""
    if mode == "none":
        return grads
    if mode not in ("bf16", "int8"):
        raise ValueError(f"unknown compression mode {mode!r}")
    gl = leaves(grads)
    if mode == "bf16":
        for g in gl:
            if g.dtype != torch.bfloat16:
                g.copy_(g.to(torch.bfloat16))
        return grads
    ul = leaves(uniforms) if uniforms is not None else None
    step = int(step)
    for i, g in enumerate(gl):
        if ul is not None:
            u = ul[i].to(device=g.device, dtype=torch.float32)
        else:
            gen = torch.Generator(device=g.device)
            gen.manual_seed(leaf_seed(step, i))
            u = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                           device=g.device)
        g.copy_(quantize_dequantize_int8(g, u))
        del u
    return grads


def compressed_bytes_per_push(n_params: int, mode: str) -> int:
    """Bytes pushed per worker per iteration under a compression mode."""
    per = {"none": 4, "bf16": 2, "int8": 1}[mode]
    return n_params * per
