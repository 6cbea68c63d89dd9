"""Wrapper of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Consumes the PagedKVPool layout in place: physical KV blocks
(NB, bs, K, hd), per-request block tables (B, MB) and first-query
positions (B,).  A CUDA tensor launches the kernel (or raises); a CPU
tensor runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {torch.bfloat16: 1, torch.float32: 0}
HEAD_DIMS = (64, 128)
BLOCK_SIZES = (8, 16)


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
    if q.device.type != "cuda":
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
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "paged_attention", 6, 10, 1)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
             B, S, H, K, hd, bs, MB, n_vis, DTYPES[q.dtype],
             DTYPES[k_pool.dtype], hd ** -0.5, _build.stream_of(q))
    _build.check_launch(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out
