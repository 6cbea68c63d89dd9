"""Wrappers of the CUDA int8 quantization kernels (``csrc/quant.cu``).

A CUDA tensor launches the kernel (or raises) through the operators
``torch.ops.repro_torch.quantize`` and ``dequantize``, whose fake
implementations give a meta tensor (the dry run's trace) the outputs'
shapes; a CPU tensor runs the plain version in ``ref.py``.  Inputs are read where they lie: x in f32 or bf16,
u as an (n,) array or one value expanded to (n,) (stride 0, read once), and
the dequantizer writes f32 or bf16.  Ragged blocks and views at an odd
offset go through the kernel file's scalar kernels, never the plain
version.  A block of more than 4,096 values (the gradient push quantizes a
whole tensor as one block) goes through the kernel file's grid-wide path,
which needs a few KB of scratch for its partial maxima.  The C interface
takes n as an int, so n >= 2**31 is refused.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref

X_DTYPES = (torch.float32, torch.bfloat16)


N_MAX = 2 ** 31 - 1               # the C interface's int n
PARTIALS_PER_SM = 8               # scratch of the grid-wide path, per SM


def _check_n(n: int, what: str):
    if n > N_MAX:
        raise ValueError(f"{what}: n={n} values; the kernel takes at most "
                         f"2**31 - 1")


def _check_block(n: int, block: int, what: str):
    if block < 1 or n % block:
        raise ValueError(f"{what}: n={n} is not a multiple of block={block}")


def is_one_value(u) -> bool:
    """u is one value expanded to (n,): every element at the same address."""
    return u.dim() == 1 and u.shape[0] > 1 and u.stride(0) == 0


def quantize(x, rand_u01, *, block: int = 256):
    """x: (n,) f32 or bf16 with n % block == 0; rand_u01: (n,) f32
    uniforms, contiguous or one value expanded (stride 0) -> (int8 (n,),
    f32 (n//block,))."""
    if x.device.type == "cpu":
        return quantize_ref(x, rand_u01, block=block)
    if x.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"quantize: unsupported device {x.device}")
    _check_n(x.numel(), "quantize")
    one_u = is_one_value(rand_u01)
    # an expanded u is checked as its one element; any other
    # non-contiguous u is refused
    _build.check_cuda("quantize", x, rand_u01[:1] if one_u else rand_u01)
    if x.dtype not in X_DTYPES or rand_u01.dtype != torch.float32 \
            or x.dim() != 1 or rand_u01.shape != x.shape:
        raise ValueError(f"quantize: need (n,) f32/bf16 x and (n,) f32 u, "
                         f"got {x.dtype}{tuple(x.shape)} and "
                         f"{rand_u01.dtype}{tuple(rand_u01.shape)}")
    _check_block(x.shape[0], block, "quantize")
    return tuple(_QUANTIZE(x, rand_u01, block, one_u))


def _quantized(x, block: int):
    n = x.shape[0]
    return (torch.empty(n, dtype=torch.int8, device=x.device),
            torch.empty(n // block, dtype=torch.float32, device=x.device))


def _launch_quantize(x, rand_u01, block: int, one_u: bool):
    """The quantize operator's CUDA implementation: the grid-wide path's
    scratch and one launch, counted."""
    n = x.shape[0]
    q, scales = _quantized(x, block)
    if n == 0:
        return q, scales
    n_sms = _build.n_sms(x.device)
    n_partial = max(n // block, PARTIALS_PER_SM * n_sms)
    partial = torch.empty(n_partial, dtype=torch.float32, device=x.device)
    fn = _build.bind("quant", "quantize", 5, 6)
    err = fn(x.data_ptr(), rand_u01.data_ptr(), q.data_ptr(),
             scales.data_ptr(), partial.data_ptr(), n, block,
             int(x.dtype == torch.bfloat16), int(one_u), n_sms, n_partial,
             _build.stream_of(x))
    _build.check_launch(err, "quantize")
    _build.LAUNCHES["quantize"] += 1
    return q, scales


_QUANTIZE = _build.define_op(
    "quantize(Tensor x, Tensor rand_u01, int block, bool one_u) -> "
    "(Tensor, Tensor)", _launch_quantize,
    lambda x, rand_u01, block, one_u: _quantized(x, block))


def dequantize(q, scales, *, block: int = 256, out_dtype=torch.float32):
    """int8 (n,) and f32 (n//block,) -> (n,) in ``out_dtype`` (f32, or bf16
    rounded to nearest even)."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scales, block=block, out_dtype=out_dtype)
    if q.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"dequantize: unsupported device {q.device}")
    _check_n(q.numel(), "dequantize")
    _build.check_cuda("dequantize", q, scales)
    n = q.shape[0]
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or q.dim() != 1 or scales.shape != (n // max(block, 1),) \
            or out_dtype not in X_DTYPES:
        raise ValueError(f"dequantize: need int8 (n,) and f32 (n/block,) "
                         f"into f32/bf16, got {q.dtype}{tuple(q.shape)} and "
                         f"{scales.dtype}{tuple(scales.shape)} into "
                         f"{out_dtype}")
    _check_block(n, block, "dequantize")
    return _DEQUANTIZE(q, scales, block, out_dtype == torch.bfloat16)


def _dequantized(q, bf16_out: bool):
    return torch.empty(q.shape[0], device=q.device, dtype=torch.bfloat16
                       if bf16_out else torch.float32)


def _launch_dequantize(q, scales, block: int, bf16_out: bool):
    """The dequantize operator's CUDA implementation: one launch,
    counted."""
    n = q.shape[0]
    x = _dequantized(q, bf16_out)
    if n == 0:
        return x
    fn = _build.bind("quant", "dequantize", 3, 4)
    err = fn(q.data_ptr(), scales.data_ptr(), x.data_ptr(), n, block,
             int(bf16_out), _build.n_sms(q.device), _build.stream_of(q))
    _build.check_launch(err, "dequantize")
    _build.LAUNCHES["dequantize"] += 1
    return x


_DEQUANTIZE = _build.define_op(
    "dequantize(Tensor q, Tensor scales, int block, bool bf16_out) -> "
    "Tensor", _launch_dequantize,
    lambda q, scales, block, bf16_out: _dequantized(q, bf16_out))
