"""Gradient push compression (the paper's ``enable_bfloat16_sendrecv``
knob, generalized; the JAX package's ``ps/compression.py``).

``bf16``  cast the pushed gradient to bfloat16 and back.
``int8``  per-tensor symmetric int8 with stochastic rounding (unbiased):
          each gradient leaf is one block of the port's int8 kernels
          (``kernels.quant``: ``quantize`` at ``block = g.numel()``, then
          ``dequantize`` back to the gradient's dtype), with uniforms drawn
          on the leaf's device from a ``torch.Generator`` seeded by (17,
          step, leaf index), a stacked leaf (``layers/...``) one layer
          slice at a time, seeded by (17, step, leaf index, layer).  The
          JAX package draws them from ``fold_in(PRNGKey(17), step)`` split
          per leaf; the two streams differ, so a test hands both the same
          uniforms (``uniforms``).

Under a mesh (``specs``, ``ms``) each rank compresses its shards of the
pushed gradient, with the numerics of the whole leaf: one scale a leaf,
from the amax all-reduced (MAX) over the axes the leaf's spec names, and
the uniforms of its shard the slice of what the whole leaf draws (each
layer slice drawn whole and narrowed), whatever the mesh.  The leaf's max
enters the kernel as one more value of the shard's block, so the kernel's
own scale is the whole leaf's.

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

from repro_torch.core.tree import flatten, leaves
from repro_torch.distributed.sharding import is_whole, shard
from repro_torch.kernels.quant import dequantize, quantize

SEED_BASE = 17


def leaf_seed(step: int, index: int, layer: int | None = None) -> int:
    """The generator seed of leaf ``index``'s uniforms at ``step`` (of its
    ``layer`` slice, for a stacked leaf)."""
    seed = (SEED_BASE * 1_000_003 + step) * 1_000_003 + index
    if layer is not None:
        seed = (seed * 1_000_003 + layer) % (1 << 63)
    return seed


def _uniforms(g, path: str, index: int, step: int, spec, ms):
    """f32 uniforms of ``g`` (the whole leaf, or its shard under ``spec``
    on ``ms``): a stacked leaf's layer slices drawn one at a time, each
    whole and narrowed to the shard."""
    sharded = spec is not None and not is_whole(spec, ms)
    whole = (tuple(n * ms.size_of(e) for n, e in zip(g.shape, spec))
             if sharded else tuple(g.shape))
    gen = torch.Generator(device=g.device)

    def draw(shape, sp, seed):
        gen.manual_seed(seed)
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=g.device)
        return shard(u, sp, ms) if sharded else u

    if not path.startswith("layers/") or g.dim() == 0:
        return draw(whole, spec, leaf_seed(step, index))
    u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for layer in range(g.shape[0]):
        u[layer] = draw(whole[1:], None if spec is None else spec[1:],
                        leaf_seed(step, index, layer))
    return u


def _qdq_shard(g, u, spec, ms):
    """``g``, a shard of a leaf, quantized with the whole leaf's scale:
    its amax all-reduced (MAX) over the axes ``spec`` names, appended to
    the shard's values as one more value of the block (whose own q is
    discarded), so the kernel's block max is the leaf's."""
    import torch.distributed as dist
    amax = g.abs().amax().float().reshape(1)
    for e in spec:
        if ms.size_of(e) > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=ms.group(e))
    n = g.numel()
    x = torch.empty(n + 1, dtype=g.dtype, device=g.device)
    x[:n] = g.reshape(-1)
    x[n:] = amax.to(g.dtype)
    uu = torch.zeros(n + 1, dtype=torch.float32, device=g.device)
    uu[:n] = u.reshape(-1)
    q, scale = quantize(x, uu, block=n + 1)
    return dequantize(q, scale, block=n + 1,
                      out_dtype=g.dtype)[:n].view(g.shape)


def quantize_dequantize_int8(g, u):
    """``g`` as one int8 block with stochastic rounding by ``u`` (f32,
    g's shape), dequantized to g's dtype."""
    flat = g.reshape(-1)
    n = flat.numel()
    q, scale = quantize(flat, u.reshape(-1), block=n)
    return dequantize(q, scale, block=n, out_dtype=g.dtype).view(g.shape)


@torch.no_grad()
def compress_grads(grads, mode: str, step, uniforms=None, specs=None,
                   ms=None):
    """``grads`` (nested dict of tensors) as pushed under ``mode``: none |
    bf16 | int8, written in place; returns ``grads``.  ``step`` is the
    host step count (int) or a 0-dim tensor (read once, for int8);
    ``uniforms`` optionally gives int8's draws as a tree of f32 tensors
    shaped like the whole leaves.  ``specs``/``ms``: ``grads`` are the
    rank's shards of the leaves, placed by ``specs`` on the mesh ``ms``
    (every rank of it calls this)."""
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
    sl = leaves(specs) if specs is not None else [None] * len(gl)
    step = int(step)
    for i, (path, g, spec) in enumerate(zip(flatten(grads)[0], gl, sl)):
        sharded = spec is not None and not is_whole(spec, ms)
        if ul is not None:
            u = ul[i].to(device=g.device, dtype=torch.float32)
            u = shard(u, spec, ms) if sharded else u
        else:
            u = _uniforms(g, path, i, step, spec, ms)
        g.copy_(_qdq_shard(g, u, spec, ms) if sharded
                else quantize_dequantize_int8(g, u))
        del u
    return grads


def compressed_bytes_per_push(n_params: int, mode: str) -> int:
    """Bytes pushed per worker per iteration under a compression mode."""
    per = {"none": 4, "bf16": 2, "int8": 1}[mode]
    return n_params * per
