"""GQA attention: the prefill path, the paged decode path and the plain
dense decode path.

CUDA tensors go to the hand-written kernels (``repro_torch.kernels``);
CPU tensors run plain PyTorch versions.  The plain paged and dense decode
paths keep the JAX package's numerics: q is cast to bf16, scores and
accumulation run in f32, and p is rounded to the cache dtype before P.V.
The prefill path follows the flash kernel instead (p stays f32), so its
outputs differ from the JAX package's ``chunked_attention`` by that one
bf16 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.paged_attention import paged_attention

NEG_INF = -1e30


def _repeat_kv(k, n_heads: int):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head G times."""
    G = n_heads // k.shape[2]
    return k if G == 1 else k.repeat_interleave(G, dim=2)


def chunked_attention(q, k, v, *, causal: bool, q_positions, kv_positions,
                      k_chunk: int = 1024):
    """Prefill attention.  q: (B, Sq, H, hd); k, v: (B, Skv, K, hd);
    positions (B, S).  Returns (B, Sq, H, hd) in q.dtype.

    On CUDA this is the flash kernel with a KV tile of ``k_chunk`` keys;
    on the CPU the kernel's plain version (f32 softmax and P.V)."""
    if q.is_cuda:
        return flash_attention(q, k, v, q_positions, kv_positions,
                               causal=causal, block_k=k_chunk)
    return attention_ref(q, k, v, q_positions, kv_positions, causal=causal)


def paged_decode_attention(q, k_pool, v_pool, block_tables, *, pos,
                           ctx_cols: int = 0):
    """Attention of S query tokens over a *paged* KV cache.

    q: (B, S, H, hd); k_pool, v_pool: (NB, bs, K, hd) physical blocks;
    block_tables: (B, MB) int32; pos: (B,) logical position of the first
    query token (query j sits at pos + j).  ``ctx_cols`` (0 = all MB) is
    the visible table prefix the engine's context bucket allows.

    CUDA tensors go to the paged-attention kernel, which reads the blocks
    in place.  CPU tensors gather the visible blocks and run one masked
    softmax over them (the JAX package's CPU schedule)."""
    if q.is_cuda:
        return paged_attention(q, k_pool, v_pool, block_tables,
                               pos.to(torch.int32), ctx_cols=ctx_cols)
    B, S, H, hd = q.shape
    NB, bs, K, _ = k_pool.shape
    MB = block_tables.shape[1]
    w = min(ctx_cols, MB) if ctx_cols else MB
    bt = block_tables[:, :w].long()
    kb = _repeat_kv(k_pool[bt].reshape(B, w * bs, K, hd), H)
    vb = _repeat_kv(v_pool[bt].reshape(B, w * bs, K, hd), H)
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    kvp = torch.arange(w * bs, device=q.device)
    mask = kvp[None, None, None, :] <= q_pos[:, None, :, None]
    return _masked_attention(q, kb, vb, mask)


def decode_attention(q, k_cache, v_cache, *, pos):
    """Attention of S query tokens over a dense KV cache (B, Smax, K, hd):
    the plain path behind ``attn_impl="gather"``.  pos: (B,) position of
    the first query token."""
    B, S, H, hd = q.shape
    kh = _repeat_kv(k_cache, H)
    vh = _repeat_kv(v_cache, H)
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    return _masked_attention(q, kh, vh, mask)


def _masked_attention(q, kh, vh, mask):
    """q (B,S,H,hd) in bf16 against head-expanded kh, vh (B,T,H,hd): f32
    scores and softmax, p rounded to the cache dtype, f32 P.V."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.bfloat16).float(),
                     kh.float()) * (hd ** -0.5)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vh.dtype).float()
    out = torch.einsum("bhqk,bkhd->bhqd", p, vh.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)                # (B,S,H,hd)
