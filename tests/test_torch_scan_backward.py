"""PyTorch port: the selective scan's gradient held to the JAX package on
the CPU, and the backward kernel's schedule emulated in plain torch.

- The plain gradient (autograd through ``selective_scan_ref``, and
  ``selective_scan_bwd``'s CPU path: each interval recomputed from its
  ``h_chk`` row) of x, dt, Bm, Cm, A and h0 against ``jax.grad`` of the
  JAX package's ``selective_scan_ref``, at N = 16 and 64, f32 and bf16
  inputs, S of 5 and 40.
- The checkpoints: ``selective_scan(..., h_chk=)`` holds the plain states
  at the interval starts and leaves y and h_last as they were.
- The kernel's schedule (``csrc/mamba_scan_bwd.cu``): each batch row's
  intervals walked from the last (their starts from h_chk), sub-interval
  starts kept by a forward pass, each sub-interval recomputed and walked
  back, sums over n on the lanes' butterfly tree, each block's sums over
  its d's (eight interleaved running sums joined as a tree), the
  cluster's rows added in rank order (blocks wholly past D included) and
  the clusters' in the reduce kernel's order, against the plain gradient;
  its constants are read from the source, and its scratch is held to
  1 / kCluster of one partial row a block.
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


K_NG, K_SUB, K_SEG, K_MAX_DB, K_CLUSTER, K_MAX_SMEM = (
    _cu_const(CU, n) for n in ("kNG", "kSub", "kSeg", "kMaxDB", "kCluster",
                               "kMaxSmem"))


def _plan(N, D):
    """(d's a block, blocks, blocks a cluster, clusters) of the backward's
    grid along d, as the kernel's d_block, cluster_size and n_clusters give
    them (the grid is clusters x blocks a cluster, its last blocks past D
    where the blocks do not fill the last cluster)."""
    dblock = min(K_MAX_DB, 1024 // N)
    nblk = -(-D // dblock)
    cluster = 1
    while cluster < K_CLUSTER and cluster < nblk:
        cluster *= 2
    return dblock, nblk, cluster, -(-nblk // cluster)


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
    """The wrappers' constants are the sources': SCAN_CHUNK the forward's
    kChunk, the model's interval CHK_STEPS the backward's kSeg (the longest
    interval it stages whole, and the longest the wrapper takes), both
    multiples of kSub.  Every state size's shared memory (``Smem<N>``: two
    staged segments, the sub-interval starts, the terms over d, the
    block's rows) fits the opt-in limit, its sums over d tile the block,
    and the grid's clusters (``_plan``) cover the blocks along d."""
    chunk = scan_kernel.SCAN_CHUNK
    assert chunk == _cu_const(CU_FWD, "kChunk")
    assert scan_kernel.CHK_STEPS == K_SEG
    assert K_SEG % chunk == 0 and chunk % K_SUB == 0

    def smem(N, dblock, threads):
        seg = (3 * K_SEG * dblock + 2 * K_SEG * N) * 4
        states = threads * K_NG * 4                 # a float per state
        return (2 * seg + (K_SEG // K_SUB) * states + 2 * K_SUB * states
                + 2 * K_SEG * N * 4)

    for N in scan_kernel.STATE_SIZES:
        dblock = min(K_MAX_DB, 1024 // N)
        threads = dblock * N // K_NG
        assert threads % 32 == 0 and threads <= 512
        assert dblock % 8 == 0 and smem(N, dblock, threads) <= K_MAX_SMEM
        sums = 2 * K_SUB * (N // 4)                 # float4 sums over d
        assert threads % sums == 0 and threads // sums in (1, 2, 4, 8)
        for D in (1, 20, 64, 300, 660, 700, 4096, 8192):
            db, nblk, c, nclu = _plan(N, D)
            assert db == dblock and c & (c - 1) == 0 and c <= K_CLUSTER
            assert c == K_CLUSTER or c >= nblk > c // 2
            assert (nclu - 1) * c < nblk <= nclu * c
    _, (x, dt, Bm, Cm, A, _), gy = _inputs(0, 1, 40, 8, 16, "f32")
    h_chk = torch.empty(1, 1, 8, 16)
    with pytest.raises(ValueError, match=f"up to {K_SEG}"):
        selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, torch.from_numpy(gy),
                           chunk=2 * K_SEG)


@pytest.mark.parametrize("form", ["falcon", "zamba2"])
def test_backward_scratch_is_one_row_a_cluster(form):
    """At the training shapes (4 x 512 tokens; falcon-mamba-7b D 8192, N
    16; zamba2-1.2b D 4096, N 64) the grid's clusters hold kCluster blocks
    each, and the backward's scratch, one gB and gC row a cluster and
    nothing for gA (the kernel's ``selective_scan_bwd_scratch``; the card
    test holds the wrapper to it), is at most 1 / kCluster of one row a
    block of 256 threads and a gA partial a batch row, the scratch before
    the clusters."""
    B, S = 4, 512
    D, N = (8192, 16) if form == "falcon" else (4096, 64)
    _, nblk, cluster, nclu = _plan(N, D)
    assert cluster == K_CLUSTER and nclu * cluster == nblk
    scratch = 2 * B * nclu * S * N
    per_block = 2 * B * -(-D // (256 // (N // 4))) * S * N + B * D * N
    assert K_CLUSTER * scratch <= per_block


def _split_sum(terms):
    """The reduce kernel's ``split_sum``: term e into running sum e % 8,
    the eight joined pairwise."""
    acc = [torch.zeros_like(terms[0]) for _ in range(8)]
    for e, t in enumerate(terms):
        acc[e % 8] = acc[e % 8] + t
    return (((acc[0] + acc[1]) + (acc[2] + acc[3]))
            + ((acc[4] + acc[5]) + (acc[6] + acc[7])))


def _tree_sum(terms):
    """A block's sum over its d's: term e into running sum e % 8, the
    eight joined as the kernel's tree (pairs j, j ^ 4, then j ^ 2, then
    j ^ 1)."""
    acc = [torch.zeros_like(terms[0]) for _ in range(8)]
    for e, t in enumerate(terms):
        acc[e % 8] = acc[e % 8] + t
    return (((acc[0] + acc[4]) + (acc[2] + acc[6]))
            + ((acc[1] + acc[5]) + (acc[3] + acc[7])))


def _butterfly(v, G):
    """Sum over the last axis (G lanes) in the kernel's xor order: lane g
    adds lane g ^ o for o = G/2, ..., 1; every lane ends with the sum (the
    kernel's reduce-scatter pairs the same lanes), and lane 0's is
    returned."""
    for o in [G >> k for k in range(1, G.bit_length()) if G >> k]:
        v = v + v[..., [g ^ o for g in range(G)]]
    return v[..., 0]


def emulate_bwd(x, dt, Bm, Cm, A, h_chk, gy, L):
    """``csrc/mamba_scan_bwd.cu`` step by step in f32 torch, vectorized
    over a block's threads, (kDB d's) x (G lanes) x (kNG states), for
    every block of the grid: those wholly past D (the last cluster's
    padding) walk zeros and join their cluster's sum as the kernel's do."""
    f = torch.float32
    x, dt, Bm, Cm, gy = (t.to(f) for t in (x, dt, Bm, Cm, gy))
    B, S, D = x.shape
    N = A.shape[1]
    kDB, _, CL, nclu = _plan(N, D)
    G = N // K_NG
    nseg = -(-S // L)
    # the clusters' rows: [which, b, cluster, t, n]
    part = torch.zeros((2, B, nclu, S, N))
    gx = torch.zeros((B, S, D))
    gdt = torch.zeros((B, S, D))
    gA_out = torch.zeros((D, N))
    gh0 = torch.zeros((B, D, N))
    log2e = torch.tensor(1.4426950408889634, dtype=f)
    rows = torch.zeros((nclu * CL, B, nseg, 2, L, N))  # each block's rows
    for blk in range(nclu * CL):
        d = torch.arange(blk * kDB, (blk + 1) * kDB)
        live = d < D
        dc = d.clamp(max=D - 1)
        Ar = torch.where(live[:, None], A[dc], 0.0).view(kDB, G, K_NG)
        a2 = Ar * log2e
        gAt = torch.zeros((kDB, G, K_NG))
        for b in range(B):
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

            for s in reversed(range(nseg)):
                t0 = s * L
                nsub = -(-min(L, S - t0) // K_SUB)
                h = torch.where(live[:, None], h_chk[b, s, dc], 0.0).view(
                    kDB, G, K_NG)
                ck = []
                for j in range(nsub):                  # pass A
                    ck.append(h)
                    if j + 1 < nsub:
                        for k in range(K_SUB):
                            h = step(h, t0 + j * K_SUB + k)[1]
                for j in reversed(range(nsub)):        # pass B, walk back
                    s0 = t0 + j * K_SUB
                    hs, as_ = [ck[j]], []
                    for k in range(K_SUB):
                        a, hn = step(hs[-1], s0 + k)
                        as_.append(a)
                        hs.append(hn)
                    red = torch.zeros((2, K_SUB, kDB, G, K_NG))
                    for k in reversed(range(K_SUB)):
                        t = s0 + k
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
                    for k in range(K_SUB):             # the block's sums over d
                        rows[blk, b, s, :, j * K_SUB + k] = _tree_sum(
                            [red[:, k, e].reshape(2, N) for e in range(kDB)])
            gh0[b, d[live]] = gh.reshape(kDB, N)[live]
            gAt = gAt + gA                             # over the batch rows
        gA_out[d[live]] = gAt.reshape(kDB, N)[live]
    for c in range(nclu):                              # rank order
        acc = rows[c * CL]
        for r in range(c * CL + 1, (c + 1) * CL):
            acc = acc + rows[r]
        for s in range(nseg):
            t0 = s * L
            n = min(L, S - t0)
            part[:, :, c, t0:t0 + n] = acc[:, s, :, :n].transpose(0, 1)
    gB = _split_sum(list(part[0].unbind(1)))           # scan_bwd_reduce
    gC = _split_sum(list(part[1].unbind(1)))
    return gx, gdt, gB, gC, gA_out, gh0


@pytest.mark.parametrize("N,D,S,L", [(16, 80, 21, 32), (64, 20, 40, 32),
                                     (4, 300, 9, 64), (32, 660, 45, 64),
                                     (8, 40, 17, 32)])
def test_kernel_schedule_matches_the_plain_gradient(N, D, S, L):
    """The emulated kernel against the plain gradient, within f32 rounding
    (it sums in its own order and takes exp2 of dt * A log2 e), gh0
    included: several blocks, a ragged last block of d's, a ragged last
    interval and sub-interval; at N = 4 (5 blocks) and N = 32 (21 blocks,
    the last holding 20 of 32 d's) a last cluster whose second block lies
    wholly past D; at N = 8, D = 40 one block, a cluster of one."""
    _, (x, dt, Bm, Cm, A, _), gy = _inputs(N + D, 2, S, D, N, "f32")
    gy = torch.from_numpy(gy)
    _, _, h_chk = scan_checkpoints_ref(x, dt, Bm, Cm, A, None, L)
    got = emulate_bwd(x, dt, Bm, Cm, A, h_chk, gy, L)
    want = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=L,
                              want_gh0=True)
    for name, g, w in zip(("gx", "gdt", "gB", "gC", "gA", "gh0"), got, want):
        _close(w.numpy(), g, F32_RTOL, name)
