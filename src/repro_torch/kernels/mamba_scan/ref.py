"""Plain PyTorch version of the selective scan (the JAX package's
``kernels/mamba_scan/ref.py``): one time step per loop iteration, in f32."""
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
