"""Mamba1 block (falcon-mamba, the ssm family): the port of the JAX
package's ``models/mamba.py`` for ``ssm_version == 1``.

The selective scan runs in the hand-written kernel
(``repro_torch.kernels.mamba_scan``) in every mode of ``mamba1_block``:
full sequence (``state=None``, the scan starts from zeros), and decode of
S >= 1 tokens from a stored state.  The projections, the causal conv, the
softplus, the ``Dskip`` term and the ``silu(z)`` gate stay plain PyTorch,
as the JAX package computes them outside any Pallas kernel.

State is ``{"conv": (B, Di, K-1), "h": (B, Di, N) f32}``.  Where the JAX
block returns a new state, decode here writes it into the ``state``
tensors it was given, *in place* (the scan kernel writes ``h`` over
itself), and returns that same dict.

``mamba2_block`` (the hybrid family) comes with a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import selective_scan


def _causal_conv1d(x, w, b, state=None, valid_len=None):
    """Depthwise causal conv.  x: (B, S, Di); w: (Di, K); b: (Di,).

    ``state`` (B, Di, K-1) is the trailing input window of the already
    processed prefix (zeros == no prefix), so the same code serves
    prefill (state=None), single-token decode (S=1 + state) and
    multi-token decode (S>1 + state).  ``valid_len`` ((1,) int64 tensor,
    right-padded prefill): the returned state is the window ending at
    token ``valid_len`` rather than at S, so pad tokens never leak into the
    recurrent state.  It stays on the device: the window is a gather, so
    one CUDA graph serves every ``valid_len`` of a prefill bucket.
    """
    B, S, Di = x.shape
    K = w.shape[1]
    if state is not None:
        past = state.to(x.dtype).transpose(1, 2)             # (B, K-1, Di)
    else:
        past = x.new_zeros((B, K - 1, Di))
    xp = torch.cat([past, x], dim=1)                         # (B, S+K-1, Di)
    # unfold K taps: sum_k x[t-K+1+k] * w[:, k]
    y = sum(xp[:, k:k + S] * w[:, k] for k in range(K))
    if valid_len is None:
        window = xp[:, S:]                                   # last K-1 inputs
    else:
        taps = valid_len + torch.arange(K - 1, device=x.device)
        window = xp.index_select(1, taps)
    return y + b, window.transpose(1, 2)


def mamba1_block(x, p, cfg, state=None, valid_len=None):
    """Falcon-mamba block.  x: (B, S, D) bf16.  Returns (out, state): a new
    state for ``state=None``, else ``state`` itself, written in place."""
    B, S, D = x.shape
    Di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    xs, z = (x @ p["in_proj"]).split(Di, dim=-1)             # (B, S, Di) x2
    xs, new_conv = _causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"],
                                  valid_len)
    xs = F.silu(xs)

    # the scan reads dt, Bm and Cm where they lie, in bf16 (Bm and Cm as
    # views of the x_proj output): widening to f32 is exact, so no cast
    dt_raw, Bm, Cm = (xs @ p["x_proj"]).split([R, N, N], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_w"] + p["dt_b"])          # (B, S, Di)
    if valid_len is not None:
        # zeroed dt makes a step a no-op (dA = exp(0) = 1, update = 0), so
        # right-pad tokens pass the recurrent state through unchanged
        pad = torch.arange(S, device=x.device) >= valid_len
        dt = dt.masked_fill(pad[None, :, None], 0.0)
    A = -torch.exp(p["A_log"].float())                       # (Di, N)
    h0 = None if state is None else state["h"]
    y, new_h = selective_scan(xs, dt, Bm, Cm, A, h0, h_out=h0)

    y = y + p["Dskip"].float() * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if state is None:
        return out, {"conv": new_conv, "h": new_h}
    state["conv"].copy_(new_conv)
    return out, state


def mamba2_block(x, p, cfg, state=None, valid_len=None):
    raise NotImplementedError(
        "mamba2_block is not ported yet: it comes with the hybrid slice of "
        "the port (zamba2)")


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero state of ``batch`` requests: conv window in ``dtype``, h f32."""
    if cfg.ssm_version != 1:
        raise NotImplementedError(
            "mamba2 state is not ported yet: it comes with the hybrid slice "
            "of the port")
    Di, K = cfg.d_inner, cfg.ssm_conv
    return {"conv": torch.zeros((batch, Di, K - 1), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, Di, cfg.ssm_state), dtype=torch.float32,
                             device=device)}
