"""Plain PyTorch versions of the flash-attention kernels: masked attention
with an f32 softmax (the JAX package's ``flash_attention/ref.py``, with the
kernel's GQA and position arguments), its rows' log-sum-exp, and its
gradient by autograd."""
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


def _scores(q, k, q_positions, kv_positions, causal):
    """(B, H, Sq, Skv) f32 scores q.k * hd^-0.5, masked to -1e30: keys in
    a query's future when causal, else keys at negative positions (the
    model's chunked attention masks them so)."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qp, kp = default_positions(q, k, q_positions, kv_positions)
    kh = k.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * (hd ** -0.5)
    if causal:
        mask = qp[:, :, None] >= kp[:, None, :]               # (B, Sq, Skv)
    else:
        mask = (kp >= 0)[:, None, :].expand(B, Sq, kp.shape[1])
    return torch.where(mask[:, None], s, NEG_INF)


def attention_lse_ref(q, k, q_positions=None, kv_positions=None, *,
                      causal: bool = True):
    """The rows' log-sum-exp of the scaled, masked scores: (B, H, Sq) f32,
    what the forward kernel writes with ``return_lse``."""
    return torch.logsumexp(_scores(q, k, q_positions, kv_positions, causal),
                           dim=-1)


def attention_bwd_ref(q, k, v, dout, q_positions=None, kv_positions=None,
                      *, causal: bool = True):
    """(dq, dk, dv) of ``attention_ref`` at ``dout``, by autograd, in the
    inputs' dtypes: the backward kernel's plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*leaves, q_positions, kv_positions,
                            causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def attention_ref(q, k, v, q_positions=None, kv_positions=None, *,
                  causal: bool = True):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 (query head
    h reads kv head h // (H/K)).  Causal masks kv position > q position;
    not causal, kv position < 0.
    f32 softmax and P.V; returns (B, Sq, H, hd) in q.dtype."""
    G = q.shape[2] // k.shape[2]
    vh = v.repeat_interleave(G, dim=2).float()
    p = torch.softmax(_scores(q, k, q_positions, kv_positions, causal),
                      dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.to(q.dtype)
