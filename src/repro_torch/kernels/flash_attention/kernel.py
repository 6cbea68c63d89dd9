"""Wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``), optionally with the row log-sum-exp, and the
backward (``csrc/flash_attention_bwd.cu``).

A CUDA tensor launches the kernel (or raises) through the operators
``torch.ops.repro_torch.flash_attention`` and ``flash_attention_bwd``,
whose fake implementations give a meta tensor (the dry run's trace) the
outputs' shapes; a CPU tensor runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     default_positions)

HEAD_DIMS = (64, 80, 96, 128)


def _check(what, q, k, v, qp, kp):
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    _build.check_cuda(what, q, k, v, qp, kp)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{what}: bf16 only, got q={q.dtype} "
                         f"k={k.dtype} v={v.dtype}")
    if (H % K or hd not in HEAD_DIMS or v.shape != k.shape
            or k.shape[0] != B or k.shape[3] != hd or Skv < 1
            or qp.shape != (B, Sq) or kp.shape != (B, Skv)):
        raise ValueError(f"{what}: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)}")


def flash_attention(q, k, v, q_positions=None, kv_positions=None, *,
                    causal: bool = True, block_k: int = 128,
                    return_lse: bool = False):
    """q: (B, Sq, H, hd) bf16; k, v: (B, Skv, K, hd) bf16 with H % K == 0.

    ``*_positions``: (S,) or (B, S) positions for the causal mask (default:
    q aligned to the end of kv); without ``causal``, keys at negative
    positions are masked.  ``block_k`` is the k_chunk knob; the
    kernel takes its own KV tile of 64 keys, so the result does not depend
    on it (nor does the plain version's).  Returns (B, Sq, H, hd) bf16,
    and with ``return_lse`` also the rows' log-sum-exp of the scaled,
    masked scores, (B, H, Sq) f32 (the backward's input).
    """
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, q_positions, kv_positions,
                            causal=causal)
        if not return_lse:
            return out
        return out, attention_lse_ref(q, k, q_positions, kv_positions,
                                      causal=causal)
    if q.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    qp, kp = default_positions(q, k, q_positions, kv_positions)
    qp = qp.to(torch.int32).contiguous()
    kp = kp.to(torch.int32).contiguous()
    _check("flash_attention", q, k, v, qp, kp)
    if block_k < 1:
        raise ValueError(f"flash_attention: block_k={block_k}")
    B, Sq, H, _ = q.shape
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out = _FWD(q, k, v, qp, kp, causal, lse)
    return (out, lse) if return_lse else out


def _launch_fwd(q, k, v, qp, kp, causal: bool, lse):
    """The forward operator's CUDA implementation: one launch, counted;
    the rows' log-sum-exp written into ``lse`` when given."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention", "flash_attention", 7, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
             kp.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, Sq, Skv, H, K, hd,
             int(causal), hd ** -0.5, _build.stream_of(q))
    _build.check_launch(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def fwd_flops(q, k, v, qp, kp, causal: bool, lse) -> int:
    """QK^T and PV over every (query, key) pair (shapes; the masked half
    of a causal square counted, as the cost model and SDPA's formula
    count it): 4 * B * Sq * Skv * H * hd."""
    B, Sq, H, hd = q
    return 4 * B * Sq * k[1] * H * hd


_FWD = _build.define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, Tensor qp, Tensor kp, "
    "bool causal, Tensor(a!)? lse) -> Tensor", _launch_fwd,
    lambda q, k, v, qp, kp, causal, lse: torch.empty_like(q),
    flops=fwd_flops)


def flash_attention_bwd(q, k, v, out, dout, lse, q_positions=None,
                        kv_positions=None, *, causal: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)``
    given its output ``out``, the output's gradient ``dout`` (both (B, Sq,
    H, hd) bf16) and the forward's ``lse`` ((B, H, Sq) f32).  dq is (B,
    Sq, H, hd), dk and dv (B, Skv, K, hd), all bf16.

    One call is two kernel launches (dq, whose prologue writes delta =
    rowsum(dout * out), then dk/dv in thread-block clusters that split a
    kv head's query heads) and counts once.  q, k, v, out and dout must
    start at 16-byte aligned addresses (the kernel loads them by TMA and
    16-byte accesses); the launch raises otherwise.  A CPU tensor runs the plain version: autograd through
    ``attention_ref`` (``out`` and ``lse`` are not read)."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, q_positions, kv_positions,
                                 causal=causal)
    if q.device.type not in _build.TRACED_DEVICES:
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    qp, kp = default_positions(q, k, q_positions, kv_positions)
    qp = qp.to(torch.int32).contiguous()
    kp = kp.to(torch.int32).contiguous()
    _check("flash_attention_bwd", q, k, v, qp, kp)
    _build.check_cuda("flash_attention_bwd", q, out, dout, lse)
    if (out.shape != q.shape or dout.shape != q.shape
            or out.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16
            or lse.shape != (B, H, Sq) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: need out and dout like q "
                         f"in bf16 and lse (B, H, Sq) f32, got "
                         f"{out.dtype}{tuple(out.shape)}, "
                         f"{dout.dtype}{tuple(dout.shape)}, "
                         f"{lse.dtype}{tuple(lse.shape)}")
    return tuple(_BWD(q, k, v, out, dout, lse, qp, kp, causal))


def _launch_bwd(q, k, v, out, dout, lse, qp, kp, causal: bool):
    """The backward operator's CUDA implementation: two launches (dq with
    delta, then dk/dv), counted once."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention_bwd", "flash_attention_bwd", 12, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), qp.data_ptr(), kp.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             B, Sq, Skv, H, K, hd, int(causal), hd ** -0.5,
             _build.stream_of(q))
    _build.check_launch(err, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def bwd_flops(q, k, v, out, dout, lse, qp, kp, causal: bool) -> int:
    """The five products of the backward (S = QK^T recomputed, dV, dP,
    dQ, dK), over every pair as ``fwd_flops``: 2.5 x the forward's."""
    B, Sq, H, hd = q
    return 10 * B * Sq * k[1] * H * hd


_BWD = _build.define_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor dout, Tensor lse, Tensor qp, Tensor kp, bool causal) -> "
    "(Tensor, Tensor, Tensor)", _launch_bwd,
    lambda q, k, v, out, dout, lse, qp, kp, causal: (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
    flops=bwd_flops)
