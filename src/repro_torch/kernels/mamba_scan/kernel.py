"""Wrapper of the CUDA selective-scan kernel (``csrc/mamba_scan.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.  Bm and Cm are read where they lie: bf16 or f32
views with a last stride of 1, such as slices of the model's ``x_proj``
output, go in without a cast or a copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

STATE_SIZES = (4, 8, 16, 32, 64)   # N (64: the mamba2 block)
SHORT_S = 8                        # S at or below: the direct kernel
_IO_DTYPES = (torch.float32, torch.bfloat16)


def launch_plan(S: int, N: int) -> tuple[int, bool]:
    """(NG, chunked) of a launch: NG states a thread (G = N / NG lanes a
    d), and whether S is long enough for the chunked kernel.  The kernel
    has a build for exactly these plans and refuses any other NG.

    Short S (decode) takes the direct kernel with 8 states a thread (all
    N where N < 8): at B = 8, D = 8192, N = 16 that is 131,072 threads,
    one wave.  Longer S takes the chunked kernel with G = min(8, N / 2)
    lanes a d: at B = 1 the card has few d's to share out, and more warps
    an SM beat more states a thread there (times of other plans:
    scripts/ab_scan_kernel.py --plans)."""
    if N not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size N={N} not in "
                         f"{STATE_SIZES}")
    if S <= SHORT_S:
        return min(8, N), False
    return max(2, N // 8), True


def bc_strides(name: str, t) -> tuple[int, int]:
    """(batch, time) strides of a (B, S, N) Bm or Cm, whose last stride
    must be 1; raises for any other layout."""
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"selective_scan: {name} needs last stride 1, got "
                         f"strides {t.stride()}")
    return t.stride(0), t.stride(1)


def selective_scan(x, dt, Bm, Cm, A, h0=None, *, h_out=None):
    """x, dt: (B, S, D) f32 or bf16; Bm, Cm: (B, S, N) f32 or bf16 (both
    the same, last stride 1); A: (D, N) f32; h0: (B, D, N) f32 or
    None (zeros).  Returns (y (B, S, D) f32, h_last (B, D, N) f32).

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
    ng, chunked = launch_plan(S, N)
    f32 = torch.float32
    want = [("dt", dt, (B, S, D), _IO_DTYPES), ("Bm", Bm, (B, S, N),
                                                 _IO_DTYPES),
            ("Cm", Cm, (B, S, N), (Bm.dtype,)), ("A", A, (D, N), (f32,))]
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
    strides = bc_strides("Bm", Bm) + bc_strides("Cm", Cm)
    dense = [x, dt, A] + [t for t in (h0, h_out) if t is not None]
    _build.check_cuda("selective_scan", *dense)
    if Bm.device != x.device or Cm.device != x.device:
        raise ValueError(f"selective_scan: tensors on {Bm.device}, "
                         f"{Cm.device} and {x.device}")
    for name, t in (("A", A), ("h0", h0), ("h_out", h_out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"selective_scan: {name} must start on 16 "
                             f"bytes (its states load as float4)")
    y = torch.empty((B, S, D), dtype=f32, device=x.device)
    if h_out is None:
        h_out = torch.empty((B, D, N), dtype=f32, device=x.device)
    fn = _build.bind("mamba_scan", "selective_scan", 8, 13)
    bf16 = torch.bfloat16
    err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_out.data_ptr(), B, S, D, N, ng, int(chunked),
             *strides, int(x.dtype == bf16), int(dt.dtype == bf16),
             int(Bm.dtype == bf16), _build.stream_of(x))
    _build.check_launch(err, "selective_scan")
    _build.LAUNCHES["selective_scan"] += 1
    return y, h_out
