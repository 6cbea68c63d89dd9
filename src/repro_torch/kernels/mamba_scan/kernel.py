"""Wrappers of the CUDA selective-scan kernels: the forward
(``csrc/mamba_scan.cu``) and, for training, its backward
(``csrc/mamba_scan_bwd.cu``).

A CUDA tensor launches the kernel (or raises) through the operators
``torch.ops.repro_torch.selective_scan`` and ``selective_scan_bwd``, whose
fake implementations give a meta tensor (the dry run's trace) the outputs'
shapes; a CPU tensor runs the plain version in ``ref.py``.  Bm and Cm are
read where they lie: bf16 or f32 views with a last stride of 1, such as
slices of the model's ``x_proj`` output, go in without a cast or a copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (scan_checkpoints_ref,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)

STATE_SIZES = (4, 8, 16, 32, 64)   # N (64: the mamba2 block)
SHORT_S = 8                        # S at or below: the direct kernel
SCAN_CHUNK = 32                    # the forward's staged chunk (kChunk)
# The training forward (models/mamba.py SelectiveScan) keeps the state
# before every CHK_STEPS steps (h_chk) for the backward, which recomputes
# each interval from it.  64: h_chk at zamba2's training shape (4 x 512
# tokens, D 4096, N 64) is 33.5 MB a layer (1.27 GB over 38 layers; 67 MB a
# layer at 32), and an interval of 64 is the longest the backward stages
# whole (its kSeg); it takes intervals of SCAN_CHUNK up to CHK_STEPS.
CHK_STEPS = 64
_IO_DTYPES = (torch.float32, torch.bfloat16)


def bwd_scratch(B: int, S: int, D: int, N: int) -> int:
    """f32 elements of the backward's scratch, as its build plans it (one
    gB and one gC row a cluster of blocks along d and a batch row); needs
    the built library, so only where the card is."""
    f = _build.library("mamba_scan_bwd").selective_scan_bwd_scratch
    if f.argtypes is None:
        f.argtypes = [ctypes.c_int] * 4
        f.restype = ctypes.c_longlong
    n = f(B, S, D, N)
    if n < 0:
        raise ValueError(f"selective_scan_bwd: no build for B={B}, S={S}, "
                         f"D={D}, N={N} (N in {STATE_SIZES})")
    return n


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


def selective_scan(x, dt, Bm, Cm, A, h0=None, *, h_out=None, h_chk=None,
                   chunk: int = CHK_STEPS):
    """x, dt: (B, S, D) f32 or bf16; Bm, Cm: (B, S, N) f32 or bf16 (both
    the same, last stride 1); A: (D, N) f32; h0: (B, D, N) f32 or
    None (zeros).  Returns (y (B, S, D) f32, h_last (B, D, N) f32).

    ``h_out`` (B, D, N) f32, optional: the tensor ``h_last`` is written
    into and returned as; it may be ``h0`` itself, so a decode step updates
    a stored state in place.  ``h_chk`` (B, ceil(S / chunk), D, N) f32,
    optional (training): filled with the state before each interval of
    ``chunk`` steps (a multiple of SCAN_CHUNK), what
    ``selective_scan_bwd`` recomputes the intervals from."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: need x (B, S, D) and A (D, N), "
                         f"got {tuple(x.shape)} and {tuple(A.shape)}")
    B, S, D = x.shape
    N = A.shape[1]
    if h_chk is not None:
        if chunk <= 0 or chunk % SCAN_CHUNK:
            raise ValueError(f"selective_scan: chunk {chunk} is not a "
                             f"positive multiple of {SCAN_CHUNK}")
        want = (B, -(-S // chunk), D, N)
        if tuple(h_chk.shape) != want or h_chk.dtype != torch.float32:
            raise ValueError(f"selective_scan: h_chk must be {want} f32, "
                             f"got {h_chk.dtype}{tuple(h_chk.shape)}")
    if x.device.type == "cpu":
        if h_chk is None:
            y, h = selective_scan_ref(x, dt, Bm, Cm, A, h0)
        else:
            y, h, chk = scan_checkpoints_ref(x, dt, Bm, Cm, A, h0, chunk)
            h_chk.copy_(chk)
        if h_out is not None:
            h = h_out.copy_(h)
        return y, h
    if x.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    launch_plan(S, N)                  # refuses a state size with no build
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
    bc_strides("Bm", Bm)
    bc_strides("Cm", Cm)
    dense = [x, dt, A] + [t for t in (h0, h_out, h_chk) if t is not None]
    _build.check_cuda("selective_scan", *dense)
    if Bm.device != x.device or Cm.device != x.device:
        raise ValueError(f"selective_scan: tensors on {Bm.device}, "
                         f"{Cm.device} and {x.device}")
    for name, t in (("A", A), ("h0", h0), ("h_out", h_out),
                    ("h_chk", h_chk)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"selective_scan: {name} must start on 16 "
                             f"bytes (its states load as float4)")
    if h_out is None:
        h_out = torch.empty((B, D, N), dtype=f32, device=x.device)
    return _SCAN(x, dt, Bm, Cm, A, h0, h_out, h_chk, chunk), h_out


def _launch_scan(x, dt, Bm, Cm, A, h0, h_out, h_chk, chunk: int):
    """The forward operator's CUDA implementation: y allocated, h_out
    (and h_chk) written, one launch, counted."""
    B, S, D = x.shape
    N = A.shape[1]
    ng, chunked = launch_plan(S, N)
    strides = bc_strides("Bm", Bm) + bc_strides("Cm", Cm)
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    fn = _build.bind("mamba_scan", "selective_scan", 9, 14)
    bf16 = torch.bfloat16
    err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_out.data_ptr(),
             None if h_chk is None else h_chk.data_ptr(), B, S, D, N, ng,
             int(chunked), *strides, int(x.dtype == bf16),
             int(dt.dtype == bf16), int(Bm.dtype == bf16), chunk,
             _build.stream_of(x))
    _build.check_launch(err, "selective_scan")
    _build.LAUNCHES["selective_scan"] += 1
    return y


_SCAN = _build.define_op(
    "selective_scan(Tensor x, Tensor dt, Tensor Bm, Tensor Cm, Tensor A, "
    "Tensor? h0, Tensor(a!) h_out, Tensor(b!)? h_chk, int chunk) -> Tensor",
    _launch_scan,
    lambda x, dt, Bm, Cm, A, h0, h_out, h_chk, chunk: torch.empty(
        x.shape, dtype=torch.float32, device=x.device))


def selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, *, chunk: int,
                       want_gh0: bool = False):
    """Gradients of ``selective_scan``'s y for the cotangent gy (B, S, D)
    f32, from the forward's inputs (as they were given to it: Bm and Cm
    may be the same views) and its ``h_chk`` at interval ``chunk``.
    Returns (gx, gdt, gB, gC, gA, gh0): gx and gdt in x's and dt's dtypes,
    gB and gC (B, S, N) contiguous in Bm's dtype, gA (D, N) f32, gh0 (B, D,
    N) f32 with ``want_gh0``, else None.  The card runs two launches of
    ``csrc/mamba_scan_bwd.cu`` (counted once); the CPU the plain version,
    autograd over each interval recomputed from ``h_chk``."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan_bwd: need x (B, S, D) and A (D, "
                         f"N), got {tuple(x.shape)} and {tuple(A.shape)}")
    B, S, D = x.shape
    N = A.shape[1]
    if S < 1 or chunk <= 0 or chunk % SCAN_CHUNK or chunk > CHK_STEPS:
        raise ValueError(f"selective_scan_bwd: need S >= 1 and a chunk that "
                         f"is a multiple of {SCAN_CHUNK} up to {CHK_STEPS}, "
                         f"got S={S}, chunk={chunk}")
    f32 = torch.float32
    want = [("x", x, (B, S, D), _IO_DTYPES), ("dt", dt, (B, S, D), _IO_DTYPES),
            ("Bm", Bm, (B, S, N), _IO_DTYPES),
            ("Cm", Cm, (B, S, N), (Bm.dtype,)), ("A", A, (D, N), (f32,)),
            ("h_chk", h_chk, (B, -(-S // chunk), D, N), (f32,)),
            ("gy", gy, (B, S, D), (f32,))]
    for name, t, shape, dtypes in want:
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"selective_scan_bwd: {name} must be {shape} "
                             f"in {dtypes}, got {t.dtype}{tuple(t.shape)}")
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, Bm, Cm, A, h_chk, gy, chunk,
                                      want_gh0)
    if x.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"selective_scan_bwd: unsupported device {x.device}")
    bc_strides("Bm", Bm)
    bc_strides("Cm", Cm)
    _build.check_cuda("selective_scan_bwd", x, dt, A, h_chk, gy)
    if Bm.device != x.device or Cm.device != x.device:
        raise ValueError(f"selective_scan_bwd: tensors on {Bm.device}, "
                         f"{Cm.device} and {x.device}")
    for name, t in (("A", A), ("h_chk", h_chk)):
        if t.data_ptr() % 16:
            raise ValueError(f"selective_scan_bwd: {name} must start on 16 "
                             f"bytes (its states load as float4)")
    gh0 = (torch.empty((B, D, N), dtype=torch.float32, device=x.device)
           if want_gh0 else None)
    return tuple(_SCAN_BWD(x, dt, Bm, Cm, A, h_chk, gy, chunk, gh0)) + (gh0,)


def _grads(x, dt, Bm, N: int):
    """gx, gdt, gB, gC and gA, uninitialised."""
    B, S, D = x.shape
    dev = x.device
    return (torch.empty((B, S, D), dtype=x.dtype, device=dev),
            torch.empty((B, S, D), dtype=dt.dtype, device=dev),
            torch.empty((B, S, N), dtype=Bm.dtype, device=dev),
            torch.empty((B, S, N), dtype=Bm.dtype, device=dev),
            torch.empty((D, N), dtype=torch.float32, device=dev))


def _launch_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk: int, gh0):
    """The backward operator's CUDA implementation: the scratch and two
    launches, counted once; gh0 (when given) written."""
    B, S, D = x.shape
    N = A.shape[1]
    strides = bc_strides("Bm", Bm) + bc_strides("Cm", Cm)
    gx, gdt, gB, gC, gA = _grads(x, dt, Bm, N)
    part = torch.empty(bwd_scratch(B, S, D, N), dtype=torch.float32,
                       device=x.device)
    fn = _build.bind("mamba_scan_bwd", "selective_scan_bwd", 14, 12)
    bf16 = torch.bfloat16
    err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), h_chk.data_ptr(), gy.data_ptr(), gx.data_ptr(),
             gdt.data_ptr(), gB.data_ptr(), gC.data_ptr(), gA.data_ptr(),
             None if gh0 is None else gh0.data_ptr(), part.data_ptr(), B, S,
             D, N, chunk, *strides, int(x.dtype == bf16),
             int(dt.dtype == bf16), int(Bm.dtype == bf16),
             _build.stream_of(x))
    _build.check_launch(err, "selective_scan_bwd")
    _build.LAUNCHES["selective_scan_bwd"] += 1
    return gx, gdt, gB, gC, gA


_SCAN_BWD = _build.define_op(
    "selective_scan_bwd(Tensor x, Tensor dt, Tensor Bm, Tensor Cm, "
    "Tensor A, Tensor h_chk, Tensor gy, int chunk, Tensor(a!)? gh0) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor)", _launch_scan_bwd,
    lambda x, dt, Bm, Cm, A, h_chk, gy, chunk, gh0: _grads(
        x, dt, Bm, A.shape[1]))
