"""Plain PyTorch versions of the selective scan (the JAX package's
``kernels/mamba_scan/ref.py``): one time step per loop iteration, in f32.

``selective_scan_ref`` is the recurrence itself.  The training forms keep
the state only at the start of each interval of ``chunk`` steps, as the
JAX package's chunk-checkpointed ``_scan_seq`` (``models/mamba.py:18``)
does: ``scan_checkpoints_ref`` is the forward that keeps them and
``selective_scan_bwd_ref`` the backward that recomputes each interval
from its start state (autograd over the interval); they are what the
card's forward with checkpoints and its backward kernel compute.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, Bm, Cm, A, h0=None):
    """x, dt: (B, S, D); Bm, Cm: (B, S, N); A: (D, N); h0: (B, D, N) or
    None (zeros).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ;  y_t = <h_t, C_t>
    Returns (y: (B, S, D) f32, h_last: (B, D, N) f32).
    """
    B, S, D = x.shape
    N = A.shape[1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, Bm, Cm, A))
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)                  # (B, D, N)
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, D), dtype=torch.float32, device=x.device))
    return y, h


def scan_checkpoints_ref(x, dt, Bm, Cm, A, h0, chunk: int):
    """(y, h_last, h_chk): the scan of ``selective_scan_ref``, run interval
    by interval, and h_chk (B, ceil(S / chunk), D, N) f32, the state before
    each interval of ``chunk`` steps (the first is h0, or zeros): what the
    forward kernel leaves for the backward.  Bit for bit the whole scan's
    y and h_last (the same steps in the same order)."""
    B, S, D = x.shape
    N = A.shape[1]
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    chk, ys = [], []
    for s in range(0, S, chunk):
        sl = slice(s, s + chunk)
        chk.append(h)
        y, h = selective_scan_ref(x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl],
                                  A, h)
        ys.append(y)
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((B, 0, D), dtype=torch.float32, device=x.device))
    h_chk = (torch.stack(chk, dim=1) if chk else
             torch.zeros((B, 0, D, N), dtype=torch.float32, device=x.device))
    return y, h, h_chk


def selective_scan_bwd_ref(x, dt, Bm, Cm, A, h_chk, gy, chunk: int,
                           want_gh0: bool = False):
    """Gradients of ``selective_scan_ref``'s y with respect to x, dt, Bm,
    Cm, A (and h0) for the cotangent gy (B, S, D), from the interval-start
    states ``h_chk`` of ``scan_checkpoints_ref``: the backward kernel's
    schedule at the level of intervals.  The intervals are walked from the
    last to the first; each is recomputed from its start state and
    differentiated by autograd in f32, the state's gradient carried into
    the interval before.  Returns (gx, gdt, gB, gC, gA, gh0): gx and gdt in
    x's and dt's dtypes, gB and gC (B, S, N) in Bm's dtype, gA (D, N) f32,
    gh0 (B, D, N) f32 with ``want_gh0``, else None."""
    B, S, D = x.shape
    f32 = torch.float32
    Af = A.float()
    gh = torch.zeros((B, D, A.shape[1]), dtype=f32, device=x.device)
    gA = torch.zeros_like(Af)
    parts = []
    for i in reversed(range(h_chk.shape[1])):
        sl = slice(i * chunk, min(S, (i + 1) * chunk))
        with torch.enable_grad():
            ins = [t[:, sl].float().detach().requires_grad_()
                   for t in (x, dt, Bm, Cm)]
            a = Af.detach().requires_grad_()
            h0 = h_chk[:, i].float().detach().requires_grad_()
            y, h_last = selective_scan_ref(*ins, a, h0)
            g = torch.autograd.grad((y, h_last), ins + [a, h0],
                                    (gy[:, sl].float(), gh))
        parts.append(g[:4])
        gA = gA + g[4]
        gh = g[5]
    parts.reverse()

    def cat(k, like):
        if not parts:
            return torch.zeros(like.shape, dtype=like.dtype, device=x.device)
        return torch.cat([p[k] for p in parts], dim=1).to(like.dtype)

    return (cat(0, x), cat(1, dt), cat(2, Bm), cat(3, Bm), gA,
            gh if want_gh0 else None)
