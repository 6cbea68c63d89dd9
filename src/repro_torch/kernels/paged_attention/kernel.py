"""Wrapper of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Consumes the PagedKVPool layout in place: physical KV blocks
(NB, bs, K, hd), per-request block tables (B, MB) and first-query
positions (B,).  A CUDA tensor launches the kernel (or raises) through the
operator ``torch.ops.repro_torch.paged_attention``, whose fake
implementation gives a meta tensor (the dry run's trace) its output's
shape; a CPU tensor runs the plain version in ``ref.py``.

The kernel splits the KV axis over CTAs (``split_plan``) and merges the
splits in the same launch; the wrapper allocates the f32 partials and
keeps one zeroed counter buffer per device, which the kernel leaves zeroed.
A CUDA graph captures that buffer by address, so it is allocated (or grown)
only outside a capture: the eager warm-up before each capture sizes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {torch.bfloat16: 1, torch.float32: 0}
HEAD_DIMS = (64, 96, 128)
BLOCK_SIZES = (8, 16)
ROWS_PER_CTA = 16          # (query token, head) rows of one CTA
STAGE_KEYS = 32            # keys of one stage; a split is whole stages
MAX_STAGES = 3             # stages of one split, all in shared memory at once

_COUNTERS: dict = {}       # device -> int32 counters, zero between launches
_OUTGROWN: list = []       # buffers a larger one replaced: graphs captured
                           # on them still write them, so they stay alive


def split_plan(B: int, S: int, H: int, K: int, bs: int, n_vis: int,
               n_sms: int):
    """(row tiles, n_split, split_keys) of a launch.  The KV axis of
    ``n_vis`` columns is cut into whole 32-key stages and shared among
    ``n_split`` splits of at most ``MAX_STAGES`` stages each, and at least
    as many as make B x K x tiles x splits about one CTA per SM.  Sized
    from n_vis alone: pos stays on the device."""
    tiles = -(-S * (H // K) // ROWS_PER_CTA)
    stages = max(1, -(-n_vis * bs // STAGE_KEYS))
    want = max(-(-n_sms // (B * K * tiles)), -(-stages // MAX_STAGES))
    per_split = -(-stages // min(want, stages))
    return tiles, -(-stages // per_split), per_split * STAGE_KEYS


def _counters(device, n: int):
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a buffer made here would live in the graph's memory pool
            raise RuntimeError("paged_attention: split counters must be "
                               "allocated before a CUDA graph capture (run "
                               "the step once eagerly first)")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                              device=device)
    return buf


def paged_attention(q, k_pool, v_pool, block_tables, pos, *,
                    ctx_cols: int = 0):
    """Attention of S query tokens per request over a paged KV cache.

    q: (B, S, H, hd) bf16 or f32; k_pool, v_pool: (NB, bs, K, hd) bf16 or
    f32 with H % K == 0; block_tables: (B, MB) int32; pos: (B,) int32
    logical position of the first query token (query j of request b sits
    at pos[b] + j).  ``ctx_cols`` (0 = all MB) bounds the visible table
    prefix.  Returns (B, S, H, hd) in q's dtype.
    """
    B, S, H, hd = q.shape
    NB, bs, K, _ = k_pool.shape
    MB = block_tables.shape[1]
    n_vis = min(ctx_cols, MB) if ctx_cols else MB
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool,
                                   block_tables[:, :n_vis], pos)
    if q.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _build.check_cuda("paged_attention", q, k_pool, v_pool, block_tables,
                      pos)
    if q.dtype not in DTYPES or k_pool.dtype not in DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_attention: dtypes q={q.dtype} "
                         f"k={k_pool.dtype} v={v_pool.dtype}")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and pos must be int32")
    if (H % K or hd not in HEAD_DIMS or bs not in BLOCK_SIZES
            or v_pool.shape != k_pool.shape or k_pool.shape[3] != hd
            or block_tables.shape[0] != B or pos.shape != (B,)):
        raise ValueError(
            f"paged_attention: unsupported shapes q={tuple(q.shape)} "
            f"pool={tuple(k_pool.shape)} tables={tuple(block_tables.shape)} "
            f"pos={tuple(pos.shape)} (hd in {HEAD_DIMS}, bs in "
            f"{BLOCK_SIZES})")
    return _OP(q, k_pool, v_pool, block_tables, pos, n_vis)


def _launch(q, k_pool, v_pool, block_tables, pos, n_vis: int):
    """The operator's CUDA implementation: the split plan, the partials,
    one launch, counted."""
    B, S, H, hd = q.shape
    NB, bs, K, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    tiles, n_split, split_keys = split_plan(B, S, H, K, bs, n_vis,
                                            _build.n_sms(q.device))
    ml = acc = cnt = None
    if n_split > 1:
        rows = B * K * tiles * n_split * ROWS_PER_CTA
        ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
        acc = torch.empty((rows, hd), dtype=torch.float32, device=q.device)
        cnt = _counters(q.device, B * K * tiles)
    fn = _build.bind("paged_attention", "paged_attention", 9, 12, 1)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in (ml, acc, cnt)),
             B, S, H, K, hd, bs, MB, n_vis, n_split, split_keys,
             DTYPES[q.dtype], DTYPES[k_pool.dtype], hd ** -0.5,
             _build.stream_of(q))
    _build.check_launch(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out


def paged_flops(q, k_pool, v_pool, block_tables, pos, n_vis: int) -> int:
    """The two products over the visible keys (shapes): QK^T and PV,
    2 x 2 * B * S * H * (n_vis * bs) * hd."""
    B, S, H, hd = q
    return 4 * B * S * H * n_vis * k_pool[1] * hd


_OP = _build.define_op(
    "paged_attention(Tensor q, Tensor k_pool, Tensor v_pool, "
    "Tensor block_tables, Tensor pos, int n_vis) -> Tensor", _launch,
    lambda q, k_pool, v_pool, block_tables, pos, n_vis: torch.empty_like(q),
    flops=paged_flops)
