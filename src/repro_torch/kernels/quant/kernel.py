"""Wrappers of the CUDA int8 quantization kernels (``csrc/quant.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref


def _check_block(n: int, block: int, what: str):
    if block < 1 or n % block:
        raise ValueError(f"{what}: n={n} is not a multiple of block={block}")


def quantize(x, rand_u01, *, block: int = 256):
    """x, rand_u01: (n,) f32 with n % block == 0 -> (int8 (n,), f32
    (n//block,))."""
    if x.device.type == "cpu":
        return quantize_ref(x, rand_u01, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    _build.check_cuda("quantize", x, rand_u01)
    if x.dtype != torch.float32 or rand_u01.dtype != torch.float32 \
            or x.dim() != 1 or rand_u01.shape != x.shape:
        raise ValueError(f"quantize: need two (n,) f32 tensors, got "
                         f"{x.dtype}{tuple(x.shape)} and "
                         f"{rand_u01.dtype}{tuple(rand_u01.shape)}")
    n = x.shape[0]
    _check_block(n, block, "quantize")
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(n // block, dtype=torch.float32, device=x.device)
    fn = _build.bind("quant", "quantize", 4, 2)
    err = fn(x.data_ptr(), rand_u01.data_ptr(), q.data_ptr(),
             scales.data_ptr(), n, block, _build.stream_of(x))
    _build.check_launch(err, "quantize")
    _build.LAUNCHES["quantize"] += 1
    return q, scales


def dequantize(q, scales, *, block: int = 256):
    """int8 (n,) and f32 (n//block,) -> f32 (n,)."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scales, block=block)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q.device}")
    _build.check_cuda("dequantize", q, scales)
    n = q.shape[0]
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or q.dim() != 1 or scales.shape != (n // max(block, 1),):
        raise ValueError(f"dequantize: need int8 (n,) and f32 (n/block,), "
                         f"got {q.dtype}{tuple(q.shape)} and "
                         f"{scales.dtype}{tuple(scales.shape)}")
    _check_block(n, block, "dequantize")
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    fn = _build.bind("quant", "dequantize", 3, 2)
    err = fn(q.data_ptr(), scales.data_ptr(), x.data_ptr(), n, block,
             _build.stream_of(q))
    _build.check_launch(err, "dequantize")
    _build.LAUNCHES["dequantize"] += 1
    return x
