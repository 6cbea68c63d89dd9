"""Wrapper of the CUDA selective-scan kernel (``csrc/mamba_scan.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

STATE_SIZES = (4, 8, 16, 32)       # N: one lane per state element, a
                                   # power-of-two group inside a warp
_IO_DTYPES = (torch.float32, torch.bfloat16)


def selective_scan(x, dt, Bm, Cm, A, h0=None, *, h_out=None):
    """x, dt: (B, S, D) f32 or bf16; Bm, Cm: (B, S, N) f32; A: (D, N) f32;
    h0: (B, D, N) f32 or None (zeros).  Returns (y (B, S, D) f32, h_last
    (B, D, N) f32).

    ``h_out`` (B, D, N) f32, optional: the tensor ``h_last`` is written
    into and returned as; it may be ``h0`` itself, so a decode step updates
    a stored state in place."""
    if x.device.type == "cpu":
        y, h = selective_scan_ref(x, dt, Bm, Cm, A, h0)
        if h_out is not None:
            h = h_out.copy_(h)
        return y, h
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: need x (B, S, D) and A (D, N), "
                         f"got {tuple(x.shape)} and {tuple(A.shape)}")
    B, S, D = x.shape
    N = A.shape[1]
    f32 = torch.float32
    want = [("dt", dt, (B, S, D), _IO_DTYPES), ("Bm", Bm, (B, S, N), (f32,)),
            ("Cm", Cm, (B, S, N), (f32,)), ("A", A, (D, N), (f32,))]
    if h0 is not None:
        want.append(("h0", h0, (B, D, N), (f32,)))
    if h_out is not None:
        want.append(("h_out", h_out, (B, D, N), (f32,)))
    if x.dtype not in _IO_DTYPES:
        raise ValueError(f"selective_scan: x must be f32 or bf16, got "
                         f"{x.dtype}")
    for name, t, shape, dtypes in want:
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"selective_scan: {name} must be {shape} in "
                             f"{dtypes}, got {t.dtype}{tuple(t.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size N={N} not in "
                         f"{STATE_SIZES}")
    _build.check_cuda("selective_scan", x, *(t for _, t, _, _ in want))
    y = torch.empty((B, S, D), dtype=f32, device=x.device)
    if h_out is None:
        h_out = torch.empty((B, D, N), dtype=f32, device=x.device)
    fn = _build.bind("mamba_scan", "selective_scan", 8, 6)
    err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_out.data_ptr(), B, S, D, N,
             int(x.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
             _build.stream_of(x))
    _build.check_launch(err, "selective_scan")
    _build.LAUNCHES["selective_scan"] += 1
    return y, h_out
