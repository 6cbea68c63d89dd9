"""Shared building blocks: norms, RoPE, parameter init."""
from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm in f32 with a ``1 + scale`` gain (zero-initialised scale is
    the identity gain), cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float):
    """numpy float32, so the frequencies are bit-identical to the JAX
    package's."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` on ``device``, copied there once: a copy from host
    memory per call would stall the host behind the device's queue."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def rope_tables(positions, head_dim: int, theta: float):
    """cos and sin of the rotary angles, (..., S, 1, head_dim/2) in f32:
    computed once per forward and shared by every layer."""
    freqs = _freqs_on(head_dim, theta, positions.device)
    ang = positions[..., :, None].float() * freqs        # (..., S, half)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope_tables(x, cos, sin):
    """x: (..., S, H, hd) rotated by ``rope_tables``' cos and sin."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None):
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan_in) — the JAX
    package's distribution, drawn from ``generator`` (the numbers differ
    from ``jax.random``'s)."""
    scale = 1.0 / np.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)
