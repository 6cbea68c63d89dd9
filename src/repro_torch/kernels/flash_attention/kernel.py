"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     default_positions)

HEAD_DIMS = (64, 128)


def flash_attention(q, k, v, q_positions=None, kv_positions=None, *,
                    causal: bool = True, block_k: int = 128):
    """q: (B, Sq, H, hd) bf16; k, v: (B, Skv, K, hd) bf16 with H % K == 0.

    ``*_positions``: (S,) or (B, S) positions for the causal mask (default:
    q aligned to the end of kv).  ``block_k`` is the k_chunk knob; the
    kernel takes its own KV tile of 64 keys, so the result does not depend
    on it (nor does the plain version's).  Returns (B, Sq, H, hd) bf16.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_positions, kv_positions,
                             causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qp, kp = default_positions(q, k, q_positions, kv_positions)
    qp = qp.to(torch.int32).contiguous()
    kp = kp.to(torch.int32).contiguous()
    _build.check_cuda("flash_attention", q, k, v, qp, kp)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention: bf16 only, got q={q.dtype} "
                         f"k={k.dtype} v={v.dtype}")
    if (H % K or hd not in HEAD_DIMS or v.shape != k.shape
            or k.shape[0] != B or k.shape[3] != hd or Skv < 1
            or qp.shape != (B, Sq) or kp.shape != (B, Skv)):
        raise ValueError(f"flash_attention: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)}")
    if block_k < 1:
        raise ValueError(f"flash_attention: block_k={block_k}")
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention", "flash_attention", 6, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
             kp.data_ptr(), out.data_ptr(), B, Sq, Skv, H, K, hd,
             int(causal), hd ** -0.5, _build.stream_of(q))
    _build.check_launch(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
