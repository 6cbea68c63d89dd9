"""PyTorch port: the selective scan's gradient held to the JAX package on
the CPU, and the backward kernel's schedule emulated in plain torch.

- The plain gradient (autograd through ``selective_scan_ref``, and
  ``selective_scan_bwd``'s CPU path: each interval recomputed from its
  ``h_chk`` row) of x, dt, Bm, Cm, A and h0 against ``jax.grad`` of the
  JAX package's ``selective_scan_ref``, at N = 16 and 64, f32 and bf16
  inputs, S of 5 and 40.
- The checkpoints: ``selective_scan(..., h_chk=)`` holds the plain states
  at the interval starts and leaves y and h_last as they were.
- The kernel's schedule (``csrc/mamba_scan_bwd.cu``): intervals walked
  from the last, sub-interval starts kept by a forward pass, each
  sub-interval recomputed and walked back, sums over n by the lanes'
  butterfly, per-block partial sums over d and their reduction in the
  kernel's order (eight interleaved running sums), against the plain
  gradient; its constants are read from the source.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import selective_scan_ref as j_scan_ref
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import (selective_scan,
                                            selective_scan_bwd,
                                            selective_scan_ref)
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan.ref import scan_checkpoints_ref

# A gradient, JAX against the port, relative to its largest |value|: in
# f32 only the order of the f32 sums and the last bit of exp differ (1e-5
# of the largest value, measured at most 2.6e-7 here); a bf16 gradient may
# round one bf16 step (2^-8 of a value) apart where the f32 values sit
# either side of a rounding boundary.
F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7

CU = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
CU_FWD = (_build.CSRC / "mamba_scan.cu").read_text()


def _cu_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


K_THREADS, K_NG, K_SUB = (_cu_const(CU, n) for n in
                          ("kThreads", "kNG", "kSub"))
K_MAX_SMEM = _cu_const(CU, "kMaxSmem")


def _inputs(seed, B, S, D, N, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)) - 1.0)).astype(
        np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, (D, N))).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    gy = rng.standard_normal((B, S, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jax_in = [jnp.asarray(t, jdt) for t in (x, dt, Bm, Cm)] + [
        jnp.asarray(A), jnp.asarray(h0)]
    torch_in = [torch.from_numpy(t).to(tdt) for t in (x, dt, Bm, Cm)] + [
        torch.from_numpy(A), torch.from_numpy(h0)]
    return jax_in, torch_in, gy


def _close(want, got, rtol, what):
    a, b = np.asarray(want, np.float32), got.detach().float().numpy()
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max())
    assert err <= rtol * float(np.abs(a).max()), (what, err)


@functools.lru_cache(maxsize=None)
def _case(N, dtype, S):
    """The inputs of one case and ``jax.grad`` of <y, gy> through the JAX
    package's plain scan with respect to x, dt, Bm, Cm, A and h0 (shared
    by the tests of one case: the JAX side is the slow part)."""
    jax_in, torch_in, gy = _inputs(N + S, 2, S, 12, N, dtype)

    def f(x, dt, Bm, Cm, A, h0):
        return jnp.sum(j_scan_ref(x, dt, Bm, Cm, A, h0)[0] * jnp.asarray(gy))

    want = jax.grad(f, argnums=tuple(range(6)))(*jax_in)
    return torch_in, torch.from_numpy(gy), [np.asarray(w, np.float32)
                                            for w in want]


CASES = [(N, dtype, S) for N in (16, 64) for dtype in ("f32", "bf16")
         for S in (5, 40)]
NAMES = ("x", "dt", "Bm", "Cm", "A", "h0")


@pytest.mark.parametrize("N,dtype,S", CASES)
def test_plain_gradient_matches_jax(N, dtype, S):
    """Autograd through the port's plain scan against ``jax.grad`` of the
    JAX package's plain scan; gradients come back in their inputs' dtypes
    as in JAX."""
    torch_in, gy, want = _case(N, dtype, S)
    leaves = [t.clone().requires_grad_() for t in torch_in]
    y, _ = selective_scan_ref(*leaves)
    got = torch.autograd.grad(y, leaves, gy)
    for name, w, g, t in zip(NAMES, want, got, torch_in):
        assert g.dtype == t.dtype, name
        _close(w, g, F32_RTOL if t.dtype == torch.float32 else BF16_RTOL,
               name)


@pytest.mark.parametrize("N,dtype,S", CASES)
def test_interval_backward_matches_jax(N, dtype, S):
    """``selective_scan_bwd``'s plain version (the kernel's schedule at the
    level of intervals: each recomputed from its ``h_chk`` row, walked from
    the last; two intervals of 32 at S = 40) against ``jax.grad``, gh0
    included."""
    (x, dt, Bm, Cm, A, h0), gy, want = _case(N, dtype, S)
    h_chk = torch.empty((2, -(-S // 32), 12, N))
    selective_scan(x, dt, Bm, Cm, A, h0, h_chk=h_chk, chunk=32)
    got = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=32,
                             want_gh0=True)
    for name, w, g in zip(NAMES, want, got):
        _close(w, g, F32_RTOL if g.dtype == torch.float32 else BF16_RTOL,
               name)


@pytest.mark.parametrize("S,chunk", [(1, 32), (37, 32), (64, 64), (130, 64)])
def test_checkpoints_are_the_plain_states_at_interval_starts(S, chunk):
    """h_chk[:, i] is the state after i * chunk steps (h0 at i = 0); y and
    h_last are those of the scan without checkpoints, bit for bit."""
    _, (x, dt, Bm, Cm, A, h0), _ = _inputs(S, 2, S, 8, 16, "f32")
    y0, hl0 = selective_scan(x, dt, Bm, Cm, A, h0)
    h_chk = torch.full((2, -(-S // chunk), 8, 16), float("nan"))
    y1, hl1 = selective_scan(x, dt, Bm, Cm, A, h0, h_chk=h_chk, chunk=chunk)
    assert torch.equal(y0, y1) and torch.equal(hl0, hl1)
    for i in range(h_chk.shape[1]):
        t = i * chunk
        want = h0 if t == 0 else selective_scan_ref(
            x[:, :t], dt[:, :t], Bm[:, :t], Cm[:, :t], A, h0)[1]
        assert torch.equal(h_chk[:, i], want), i


def test_scan_wrappers_refuse_bad_checkpoints():
    _, (x, dt, Bm, Cm, A, _), gy = _inputs(0, 1, 40, 8, 16, "f32")
    with pytest.raises(ValueError, match="multiple of 32"):
        selective_scan(x, dt, Bm, Cm, A, h_chk=torch.empty(1, 4, 8, 16),
                       chunk=10)
    with pytest.raises(ValueError, match="h_chk must be"):
        selective_scan(x, dt, Bm, Cm, A, h_chk=torch.empty(1, 1, 8, 16),
                       chunk=32)
    with pytest.raises(ValueError, match="h_chk must be"):
        selective_scan_bwd(x, dt, Bm, Cm, A, torch.empty(1, 1, 8, 16),
                           torch.from_numpy(gy), chunk=32)


def test_plan_and_interval_match_the_kernel_builds():
    """The wrappers' constants are the sources': BWD_THREADS and BWD_NG the
    backward's kThreads and kNG, SCAN_CHUNK the forward's kChunk; the
    model's interval CHK_STEPS and the longest the backward takes, CHK_MAX,
    are multiples of both kChunk and kSub, and CHK_MAX is the longest such
    interval whose shared memory fits the opt-in limit."""
    assert (scan_kernel.BWD_THREADS, scan_kernel.BWD_NG) == (K_THREADS, K_NG)
    chunk = scan_kernel.SCAN_CHUNK
    assert chunk == _cu_const(CU_FWD, "kChunk")

    def smem(L):
        return (2 * K_SUB + L // K_SUB) * K_THREADS * 16

    for L in (scan_kernel.CHK_STEPS, scan_kernel.CHK_MAX):
        assert L % chunk == 0 and L % K_SUB == 0 and smem(L) <= K_MAX_SMEM
    assert scan_kernel.CHK_STEPS <= scan_kernel.CHK_MAX
    assert smem(scan_kernel.CHK_MAX + chunk) > K_MAX_SMEM
    for N in scan_kernel.STATE_SIZES:
        ng, dblock = scan_kernel.bwd_plan(N)
        assert ng == K_NG and dblock * (N // K_NG) == K_THREADS


def _split_sum(terms):
    """The kernel's ``split_sum``: term e into running sum e % 8, the
    eight joined pairwise."""
    acc = [torch.zeros_like(terms[0]) for _ in range(8)]
    for e, t in enumerate(terms):
        acc[e % 8] = acc[e % 8] + t
    return (((acc[0] + acc[1]) + (acc[2] + acc[3]))
            + ((acc[4] + acc[5]) + (acc[6] + acc[7])))


def _butterfly(v, G):
    """Sum over the last axis (G lanes) in the kernel's xor order: lane g
    adds lane g ^ o for o = G/2, ..., 1; every lane ends with the sum, and
    lane 0's is returned."""
    for o in [G >> k for k in range(1, G.bit_length()) if G >> k]:
        v = v + v[..., [g ^ o for g in range(G)]]
    return v[..., 0]


def emulate_bwd(x, dt, Bm, Cm, A, h_chk, gy, L):
    """``csrc/mamba_scan_bwd.cu`` step by step in f32 torch, vectorized
    over a block's threads: (kDB d's) x (G lanes) x (kNG states)."""
    f = torch.float32
    x, dt, Bm, Cm, gy = (t.to(f) for t in (x, dt, Bm, Cm, gy))
    B, S, D = x.shape
    N = A.shape[1]
    G = N // K_NG
    kDB = K_THREADS // G
    nblk = -(-D // kDB)
    n_chk = -(-S // L)
    part = torch.zeros(2 * B * nblk * S * N + B * D * N)
    pbc = part[:2 * B * nblk * S * N].view(2, B, nblk, S, N)
    pA = part[2 * B * nblk * S * N:].view(B, D, N)
    gx = torch.zeros((B, S, D))
    gdt = torch.zeros((B, S, D))
    log2e = torch.tensor(1.4426950408889634, dtype=f)
    for b in range(B):
        for blk in range(nblk):
            d = torch.arange(blk * kDB, (blk + 1) * kDB)
            live = d < D
            dc = d.clamp(max=D - 1)
            Ar = torch.where(live[:, None], A[dc], 0.0).view(kDB, G, K_NG)
            a2 = Ar * log2e
            gh = torch.zeros((kDB, G, K_NG))
            gA = torch.zeros((kDB, G, K_NG))

            def inputs(t):
                if t >= S:
                    z = torch.zeros(kDB)
                    return z, z, torch.zeros((G, K_NG))
                dtv = torch.where(live, dt[b, t, dc], 0.0)
                xv = torch.where(live, x[b, t, dc], 0.0)
                return dtv, xv, Bm[b, t].view(G, K_NG)

            def step(h, t):
                dtv, xv, bv = inputs(t)
                a = torch.exp2(dtv[:, None, None] * a2)
                return a, a * h + (dtv * xv)[:, None, None] * bv

            for i in reversed(range(n_chk)):
                s0 = i * L
                nsub = -(-min(L, S - s0) // K_SUB)
                h = torch.where(live[:, None], h_chk[b, i, dc],
                                0.0).view(kDB, G, K_NG)
                ck = []
                for j in range(nsub):                  # pass A
                    ck.append(h)
                    if j + 1 < nsub:
                        for k in range(K_SUB):
                            h = step(h, s0 + j * K_SUB + k)[1]
                for j in reversed(range(nsub)):        # pass B
                    t0 = s0 + j * K_SUB
                    hs, as_ = [ck[j]], []
                    for k in range(K_SUB):
                        a, hn = step(hs[-1], t0 + k)
                        as_.append(a)
                        hs.append(hn)
                    red = torch.zeros((2, K_SUB, kDB, G, K_NG))
                    for k in reversed(range(K_SUB)):
                        t = t0 + k
                        dtv, xv, bv = inputs(t)
                        if t < S:
                            gyv = torch.where(live, gy[b, t, dc], 0.0)
                            cv = Cm[b, t].view(G, K_NG)
                        else:
                            gyv, cv = torch.zeros(kDB), torch.zeros(G, K_NG)
                        u = (dtv * xv)[:, None, None]
                        gh = gh + gyv[:, None, None] * cv
                        red[1, k] = gyv[:, None, None] * hs[k + 1]
                        red[0, k] = gh * u
                        s1 = _butterfly((gh * bv).sum(-1), G)
                        w = gh * as_[k] * hs[k]
                        s2 = _butterfly((w * Ar).sum(-1), G)
                        gA = gA + w * dtv[:, None, None]
                        gh = gh * as_[k]
                        if t < S:
                            gx[b, t, d[live]] = (dtv * s1)[live]
                            gdt[b, t, d[live]] = (xv * s1 + s2)[live]
                    for k in range(K_SUB):             # sums over the d's
                        if t0 + k < S:
                            pbc[:, b, blk, t0 + k] = _split_sum(
                                [red[:, k, e].reshape(2, N)
                                 for e in range(kDB)])
            pA[b, d[live]] = gA.reshape(kDB, N)[live]
    gB = _split_sum(list(pbc[0].unbind(1)))            # scan_bwd_reduce
    gC = _split_sum(list(pbc[1].unbind(1)))
    gA = torch.zeros((D, N))
    for b in range(B):
        gA = gA + pA[b]
    return gx, gdt, gB, gC, gA, gh


@pytest.mark.parametrize("N,D,S,L", [(16, 80, 21, 32), (64, 20, 40, 32),
                                     (4, 300, 9, 64)])
def test_kernel_schedule_matches_the_plain_gradient(N, D, S, L):
    """The emulated kernel (several blocks, a ragged last block of d's, a
    ragged last interval and sub-interval) against the plain gradient,
    within f32 rounding (it sums in its own order and takes exp2 of dt * A
    log2 e)."""
    _, (x, dt, Bm, Cm, A, _), gy = _inputs(N + D, 2, S, D, N, "f32")
    gy = torch.from_numpy(gy)
    _, _, h_chk = scan_checkpoints_ref(x, dt, Bm, Cm, A, None, L)
    got = emulate_bwd(x, dt, Bm, Cm, A, h_chk, gy, L)
    want = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=L)
    for name, g, w in zip(("gx", "gdt", "gB", "gC", "gA"), got, want):
        _close(w.numpy(), g, F32_RTOL, name)
