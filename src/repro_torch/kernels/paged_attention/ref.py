"""Plain PyTorch version of the paged-attention kernel: gather the block
table into a dense cache, then masked full-softmax attention in f32 (the
JAX package's ``paged_attention/ref.py``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_kv(pool, block_tables):
    """(NB, bs, K, hd) + (B, MB) -> dense (B, MB*bs, K, hd): the logical
    view of each request's cache (stale table entries gather the trash
    block — their positions are masked by the caller)."""
    B, MB = block_tables.shape
    NB, bs, K, hd = pool.shape
    return pool[block_tables.long()].reshape(B, MB * bs, K, hd)


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos):
    """Same contract as ``kernel.paged_attention``; f32 softmax throughout.

    q: (B, S, H, hd); pools: (NB, bs, K, hd); block_tables: (B, MB);
    pos: (B,) first-query logical position.  Returns (B, S, H, hd).
    """
    B, S, H, hd = q.shape
    G = H // k_pool.shape[2]
    kg = gather_kv(k_pool, block_tables).repeat_interleave(G, dim=2).float()
    vg = gather_kv(v_pool, block_tables).repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg) * (hd ** -0.5)
    kv_pos = torch.arange(kg.shape[1], device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]        # (B, S, MB*bs)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vg)
    return out.permute(0, 2, 1, 3).to(q.dtype)
