"""GQA attention: the prefill and training path, the paged decode path, the
hybrid's slab decode (the paged path over a dense slab viewed as blocks)
and the plain dense decode path.

CUDA tensors go to the hand-written kernels (``repro_torch.kernels``);
CPU tensors run plain PyTorch versions.  Meta tensors (the dry run's trace
of a step, ``launch/dryrun.py``) take the card's path, where the kernels'
operators give only their outputs' shapes.  In training (autograd on) the
prefill path is differentiable: on CUDA an ``autograd.Function`` whose
forward is the flash kernel (with the rows' log-sum-exp) and whose
backward is the flash backward kernel; on the CPU autograd runs through
the plain version.  The plain versions keep the JAX package's numerics:
q is cast to bf16, scores and accumulation run in f32, and p is rounded to
the cache's (or v's) dtype before P.V.  On the CPU the prefill path is
``blocked_attention``, the JAX package's ``chunked_attention`` block by
block (online softmax over kv blocks of ``k_chunk``); the flash kernel on
the card rounds p to bf16 for its tensor-core P.V in the same way, over
its own 64-key tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import paged_attention

NEG_INF = -1e30


def _repeat_kv(k, n_heads: int):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head G times."""
    G = n_heads // k.shape[2]
    return k if G == 1 else k.repeat_interleave(G, dim=2)


class FlashAttention(torch.autograd.Function):
    """The flash kernels as one differentiable op: the forward saves its
    inputs, output and rows' log-sum-exp; the backward recomputes P from
    them in the backward kernel.  It keeps no state of its own, so it runs
    again as it ran the first time under ``torch.utils.checkpoint``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal):
        out, lse = flash_attention(q, k, v, q_positions, kv_positions,
                                   causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qp, kp = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, qp, kp, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def blocked_attention(q, k, v, *, causal: bool, q_positions, kv_positions,
                      k_chunk: int = 1024):
    """The JAX package's ``chunked_attention`` in plain PyTorch: kv blocks
    of ``k_chunk`` keys (halved until it divides Skv), a running max and sum
    in f32, P = exp(s - m) rounded to v's dtype for P.V, masked scores at
    -1e30 (without ``causal``, keys at negative positions are masked).
    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); positions (B, S).  Returns
    (B, Sq, H, hd) in q.dtype; autograd runs through it."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    k_chunk = min(k_chunk, Skv)
    while Skv % k_chunk:
        k_chunk //= 2
    f32 = torch.float32
    qf = q.to(torch.bfloat16).to(f32)
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=f32, device=q.device)
    for c0 in range(0, Skv, k_chunk):
        kb = _repeat_kv(k[:, c0:c0 + k_chunk], H)
        vb = _repeat_kv(v[:, c0:c0 + k_chunk], H)
        kp = kv_positions[:, c0:c0 + k_chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(f32)) * hd ** -0.5
        if causal:
            mask = q_positions[:, None, :, None] >= kp[:, None, None, :]
        else:
            mask = (kp >= 0)[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vb.dtype).to(f32),
                          vb.to(f32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_positions, kv_positions,
                      k_chunk: int = 1024):
    """Prefill and training attention.  q: (B, Sq, H, hd); k, v: (B, Skv,
    K, hd); positions (B, S).  Returns (B, Sq, H, hd) in q.dtype.

    On CUDA this is the flash kernel (``k_chunk`` is passed as its
    ``block_k``, which the kernel's fixed 64-key tile does not need), and
    with autograd on, ``FlashAttention`` (forward and backward kernels);
    on the CPU ``blocked_attention`` (the JAX package's numerics), through
    which autograd runs."""
    if q.device.type != "cpu":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), q_positions,
                                        kv_positions, causal)
        return flash_attention(q, k, v, q_positions, kv_positions,
                               causal=causal, block_k=k_chunk)
    return blocked_attention(q, k, v, causal=causal, q_positions=q_positions,
                             kv_positions=kv_positions, k_chunk=k_chunk)


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
    if q.device.type != "cpu":
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


def slab_block(max_seq: int) -> int:
    """Rows of one block of a slab's block view: 16 (a block size of the
    paged-attention kernel), or the largest power of two dividing
    ``max_seq``."""
    return next(bs for bs in (16, 8, 4, 2, 1) if max_seq % bs == 0)


def identity_tables(n_slots: int, max_seq: int, device):
    """Block tables of a slab (n_slots, max_seq, K, hd) viewed as blocks
    of ``slab_block(max_seq)`` rows: slot b's column j is block
    b * cols + j.  (n_slots, cols) int32."""
    cols = max_seq // slab_block(max_seq)
    return torch.arange(n_slots * cols, dtype=torch.int32,
                        device=device).view(n_slots, cols)


def slab_decode_attention(q, k_slab, v_slab, tables, *, pos):
    """Attention of S query tokens over a dense per-slot KV slab (B,
    max_seq, K, hd), the hybrid's shared-block cache: JAX's dense
    ``decode_attention``.  The slab is viewed without a copy as blocks of
    ``slab_block(max_seq)`` rows addressed by ``identity_tables``, so on
    CUDA the paged-attention kernel reads it in place (and on the CPU the
    paged path's plain version gathers it back whole)."""
    B, T, K, hd = k_slab.shape
    bs = T // tables.shape[1]
    return paged_decode_attention(q, k_slab.view(B * T // bs, bs, K, hd),
                                  v_slab.view(B * T // bs, bs, K, hd),
                                  tables, pos=pos)


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
