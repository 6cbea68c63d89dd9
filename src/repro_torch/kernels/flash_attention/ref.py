"""Plain PyTorch version of the flash-attention kernel: masked attention
with an f32 softmax (the JAX package's ``flash_attention/ref.py``, with the
kernel's GQA and position arguments)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def default_positions(q, k, q_positions=None, kv_positions=None):
    """(B, Sq) and (B, Skv) positions; the defaults align q with the end
    of the kv sequence (q at Skv-Sq .. Skv-1), as the JAX kernel does.
    1-D positions apply to every request."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device) + (Skv - Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)
    return (q_positions.expand(B, Sq) if q_positions.dim() == 1
            else q_positions,
            kv_positions.expand(B, Skv) if kv_positions.dim() == 1
            else kv_positions)


def attention_ref(q, k, v, q_positions=None, kv_positions=None, *,
                  causal: bool = True):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 (query head
    h reads kv head h // (H/K)).  Causal masks kv position > q position.
    f32 softmax and P.V; returns (B, Sq, H, hd) in q.dtype."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qp, kp = default_positions(q, k, q_positions, kv_positions)
    kh = k.repeat_interleave(G, dim=2).float()
    vh = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * (hd ** -0.5)
    if causal:
        mask = qp[:, :, None] >= kp[:, None, :]               # (B, Sq, Skv)
        s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.to(q.dtype)
