"""Mamba blocks: mamba1 (falcon-mamba, the ssm family) and mamba2 (zamba2,
the hybrid family), the port of the JAX package's ``models/mamba.py``.

The selective scan runs in the hand-written kernel
(``repro_torch.kernels.mamba_scan``) in every mode of both blocks: full
sequence (``state=None``, the scan starts from zeros), and decode of
S >= 1 tokens from a stored state.  The projections, the causal conv, the
softplus, the skip term and the gates stay plain PyTorch, as the JAX
package computes them outside any Pallas kernel.  The mamba2 recurrence
(a scalar A per head, one B/C group) is the mamba1 recurrence over
channels d = (head, p), with a head's dt and A repeated over its P
channels: the same kernel at N = 64.

Training (autograd on, scan inputs that need a gradient) takes the role
of the JAX package's chunk-checkpointed ``_scan_seq``: ``SelectiveScan``,
the forward keeping the state before every interval of CHK_STEPS steps
and the backward recomputing each interval from it, on the card the two
kernels, on the CPU their plain versions.  It returns no state.

State is ``{"conv": (B, Di, K-1), "h": (B, Di, N) | (B, nh, P, N) f32}``.
Where the JAX block returns a new state, decode here writes it into the
``state`` tensors it was given, *in place* (the scan kernel writes ``h``
over itself), and returns that same dict.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import (selective_scan,
                                            selective_scan_bwd)
from repro_torch.kernels.mamba_scan.kernel import CHK_STEPS
from repro_torch.models import common


class SelectiveScan(torch.autograd.Function):
    """The scan as one differentiable op, y of (x, dt, Bm, Cm, A) from
    zeros: ``selective_scan`` with ``h_chk`` (the state before each
    interval of CHK_STEPS steps), saving its inputs and ``h_chk``;
    ``selective_scan_bwd`` recomputing each interval from them.  Both
    wrappers launch their kernels for CUDA tensors and run the plain
    versions for CPU tensors.  It keeps no state of its own, so it runs
    again as it ran the first time under ``torch.utils.checkpoint``."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A):
        B, S, D = x.shape
        h_chk = torch.empty((B, -(-S // CHK_STEPS), D, A.shape[1]),
                            dtype=torch.float32, device=x.device)
        y, _ = selective_scan(x, dt, Bm, Cm, A, h_chk=h_chk, chunk=CHK_STEPS)
        ctx.save_for_backward(x, dt, Bm, Cm, A, h_chk)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, dt, Bm, Cm, A, h_chk = ctx.saved_tensors
        gx, gdt, gB, gC, gA, _ = selective_scan_bwd(
            x, dt, Bm, Cm, A, h_chk, gy.contiguous(), chunk=CHK_STEPS)
        return gx, gdt, gB, gC, gA


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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
    state for ``state=None``, else ``state`` itself, written in place; in
    training (``state=None`` with autograd on) no state (None)."""
    B, S, D = x.shape
    Di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    xs, z = (x @ p["in_proj"]).split(Di, dim=-1)             # (B, S, Di) x2
    xs, new_conv = _causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"],
                                  valid_len)
    xs = common.silu(xs)

    # the scan reads dt, Bm and Cm where they lie, in bf16 (Bm and Cm as
    # views of the x_proj output): widening to f32 is exact, so no cast
    dt_raw, Bm, Cm = (xs @ p["x_proj"]).split([R, N, N], dim=-1)
    dt = common.softplus(dt_raw @ p["dt_w"] + p["dt_b"])     # (B, S, Di)
    if valid_len is not None:
        # zeroed dt makes a step a no-op (dA = exp(0) = 1, update = 0), so
        # right-pad tokens pass the recurrent state through unchanged
        pad = torch.arange(S, device=x.device) >= valid_len
        dt = dt.masked_fill(pad[None, :, None], 0.0)
    A = -torch.exp(p["A_log"].float())                       # (Di, N)
    h0 = None if state is None else state["h"]
    train = state is None and _wants_grad(xs, dt, Bm, Cm, A)
    if train:
        y, new_h = SelectiveScan.apply(xs, dt, Bm, Cm, A), None
    else:
        y, new_h = selective_scan(xs, dt, Bm, Cm, A, h0, h_out=h0)

    y = y + p["Dskip"].float() * xs.float()
    y = y.to(x.dtype) * common.silu(z)
    out = y @ p["out_proj"]
    if train:
        return out, None
    if state is None:
        return out, {"conv": new_conv, "h": new_h}
    state["conv"].copy_(new_conv)
    return out, state


def mamba2_block(x, p, cfg, state=None, valid_len=None):
    """Zamba2 block (single B/C group, scalar A per head).  x: (B, S, D)
    bf16.  Returns (out, state) as ``mamba1_block`` does (no state in
    training); h is (B, nh, P, N) f32.  Every input of the recurrence is
    f32, as in the JAX block: rounding x, dt, B or C to bf16 would move the
    result off it.  In training the gradients of ``dt_d`` and ``A_d`` sum
    back over a head's P channels through their expansions."""
    B, S, D = x.shape
    Di, N = cfg.d_inner, cfg.ssm_state
    P, nh = cfg.ssm_head_dim, cfg.n_ssm_heads

    xs, z = (x @ p["in_proj"]).split(Di, dim=-1)             # (B, S, Di) x2
    xs, new_conv = _causal_conv1d(xs, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"],
                                  valid_len)
    xs = common.silu(xs)

    # f32 views of one f32 copy, last stride 1: the scan reads them there
    Bm, Cm = (x @ p["BC_proj"]).float().split(N, dim=-1)     # (B, S, N) x2
    dt = common.softplus(x @ p["dt_proj2"] + p["dt_bias2"]).float()
    if valid_len is not None:
        # as in mamba1: dt = 0 at pad positions passes the state through
        pad = torch.arange(S, device=x.device) >= valid_len
        dt = dt.masked_fill(pad[None, :, None], 0.0)         # (B, S, nh)
    A = -torch.exp(p["A_log2"].float())                      # (nh,)
    xf = xs.float()                                          # (B, S, Di)
    # a head's dt and A over its P channels (the kernel reads dt dense)
    dt_d = dt[..., None].expand(B, S, nh, P).reshape(B, S, Di)
    A_d = A[:, None, None].expand(nh, P, N).reshape(Di, N)
    h0 = None if state is None else state["h"].view(B, Di, N)
    train = state is None and _wants_grad(xf, dt_d, Bm, Cm, A_d)
    if train:
        y, new_h = SelectiveScan.apply(xf, dt_d, Bm, Cm, A_d), None
    else:
        y, new_h = selective_scan(xf, dt_d, Bm, Cm, A_d, h0, h_out=h0)

    Dskip = p["Dskip2"].float()[:, None].expand(nh, P).reshape(Di)
    y = y + Dskip * xf
    # gated RMSNorm, in f32
    y = y * common.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps)
    y = (y * (1.0 + p["gnorm"].float())).to(x.dtype)
    out = y @ p["out_proj"]
    if train:
        return out, None
    if state is None:
        return out, {"conv": new_conv, "h": new_h.view(B, nh, P, N)}
    state["conv"].copy_(new_conv)
    return out, state


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero state of ``batch`` requests: conv window in ``dtype``, h f32
    ((B, Di, N) for mamba1, (B, nh, P, N) for mamba2)."""
    Di, K = cfg.d_inner, cfg.ssm_conv
    h = ((batch, Di, cfg.ssm_state) if cfg.ssm_version == 1 else
         (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    return {"conv": torch.zeros((batch, Di, K - 1), dtype=dtype,
                                device=device),
            "h": torch.zeros(h, dtype=torch.float32, device=device)}
