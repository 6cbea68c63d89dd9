"""PyTorch port: the selective-scan kernel's schedule, emulated in plain
torch on the CPU and held to the port's plain version, to the JAX
package's Pallas kernel (interpret mode, no h0) and to the JAX plain
version (with h0).

The kernel (``csrc/mamba_scan.cu``) gives each (b, d) G = N / NG lanes of
NG states each.  A step's exponentials are exp2(dt * (A log2 e)); a lane
sums its NG products h * C in order, and the G lanes' parts are added by
halving distances (G / 2 first).  Short S runs step by step (the direct
kernel, an all-lane butterfly); long S is staged in chunks of kChunk steps
in a ring of two buffers, the last one padded with dt = x = 0, and G
consecutive steps are reduced together by a reduce-scatter after which
lane g holds step g.  The CUDA
kernel runs only on the card (``test_torch_cuda.py`` and ``chip_smoke.py``
hold it to the same plain version there); these tests show that the
schedule itself is right."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import selective_scan as j_scan
from repro.kernels.mamba_scan import selective_scan_ref as j_scan_ref
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.kernel import (SHORT_S, STATE_SIZES,
                                                   bc_strides, launch_plan)

from _torch_port import f32

RNG = np.random.default_rng(14)
T = torch.from_numpy
LOG2E = float(np.float32(1.4426950408889634))
# f32 rounding of exp2 against exp, of the state update and of the <h, C>
# sum in another order over <= 512 steps of a contracting recurrence: the
# bound chip_smoke.py and test_torch_cuda.py hold the kernel to
SCAN_TOL = 1e-4
# The kernel's own layout constants, read from its source so that these
# tests follow any change to them.
CU = (_build.CSRC / "mamba_scan.cu").read_text()


def _cu_const(name):
    return re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1)


CHUNK, D_BLOCK = int(_cu_const("kChunk")), int(_cu_const("kDBlock"))


def _cu_ng(name, N):
    """The kernel's NG of one build for N states: its constant, one C
    conditional ``cond ? a : b`` over N, evaluated."""
    cond, a, b = re.fullmatch(r"(.+) \? (.+) : (.+)", _cu_const(name)).groups()
    ev = lambda e: eval(e.replace("/", "//"), {"N": N})       # noqa: E731
    return ev(a) if ev(cond) else ev(b)


def reduce_scatter(v):
    """v: (..., G lanes, G steps), each lane's part of G consecutive
    steps.  The kernel's recursive halving: at distance o the lane with
    bit o clear keeps the lower half of the steps and receives its
    partner's; returns (..., G lanes), lane g holding step g's sum."""
    G = v.shape[-1]
    lanes = torch.arange(G)
    o = G // 2
    while o:
        hi = ((lanes & o) != 0)[:, None]
        send = torch.where(hi, v[..., :o], v[..., o:2 * o])
        keep = torch.where(hi, v[..., o:2 * o], v[..., :o])
        v = keep + send[..., lanes ^ o, :]
        o //= 2
    return v[..., 0]


def scan_schedule(x, dt, Bm, Cm, A, h0=None):
    """The kernel's schedule in f32 torch; returns (y, h_last)."""
    B, S, D = x.shape
    N = A.shape[1]
    ng, chunked = launch_plan(S, N)
    G = N // ng
    lanes = torch.arange(G)
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    a2 = (A.float() * LOG2E).reshape(D, G, ng)          # lane g: its states
    h = (torch.zeros((B, D, G, ng)) if h0 is None
         else h0.float().reshape(B, D, G, ng).clone())
    u = dtf * xf                                        # staged once
    if chunked:                 # the last chunk padded with dt = x = 0
        pad = -S % CHUNK
        dtf, u = (torch.cat([t, torch.zeros((B, pad, D))], 1)
                  for t in (dtf, u))
        Bf, Cf = (torch.cat([t, torch.zeros((B, pad, N))], 1)
                  for t in (Bf, Cf))

    def lane_parts(t):
        nonlocal h
        dA = torch.exp2(dtf[:, t, :, None, None] * a2)
        h = dA * h + u[:, t, :, None, None] * Bf[:, t].reshape(B, 1, G, ng)
        prod = h * Cf[:, t].reshape(B, 1, G, ng)
        p = prod[..., 0]
        for j in range(1, ng):                          # in-thread, in order
            p = p + prod[..., j]
        return p                                        # (B, D, G)

    y = torch.zeros((B, dtf.shape[1], D))
    if not chunked:
        for t in range(S):
            p = lane_parts(t)
            o = G // 2
            while o:                                    # all-lane butterfly
                p = p + p[..., lanes ^ o]
                o //= 2
            y[:, t] = p[..., 0]
    else:
        for t in range(0, dtf.shape[1], G):
            parts = torch.stack([lane_parts(t + k) for k in range(G)], -1)
            y[:, t:t + G] = reduce_scatter(parts).transpose(1, 2)
    return y[:, :S], h.reshape(B, D, N)


def _inputs(B, S, D, N, h0=False, bf16=False):
    x = RNG.standard_normal((B, S, D)).astype(np.float32)
    dt = np.abs(RNG.standard_normal((B, S, D))).astype(np.float32) * 0.1
    Bm = RNG.standard_normal((B, S, N)).astype(np.float32)
    Cm = RNG.standard_normal((B, S, N)).astype(np.float32)
    A = -np.abs(RNG.standard_normal((D, N))).astype(np.float32) - 0.1
    hz = RNG.standard_normal((B, D, N)).astype(np.float32) if h0 else None
    if bf16:                    # the model's inputs: rounded to bf16 once
        x, dt, Bm, Cm = (f32(T(a).to(torch.bfloat16)) for a in (x, dt, Bm,
                                                                 Cm))
    return x, dt, Bm, Cm, A, hz


def _t(arrs):
    return [None if a is None else T(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_reduce_scatter_leaves_step_g_on_lane_g(G):
    """Lane g ends with the sum of step g over all G lanes, with the
    lanes added at halving distances, as the all-lane butterfly adds
    them."""
    v = T(RNG.standard_normal((3, G, G)).astype(np.float32))
    got = reduce_scatter(v)                             # (3, G lanes)
    p, lanes = v.clone(), torch.arange(G)
    o = G // 2
    while o:
        p = p + p[:, lanes ^ o]
        o //= 2
    assert torch.equal(got, p[:, 0])                    # same tree, order
    np.testing.assert_allclose(f32(got), f32(v.sum(1)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("N", STATE_SIZES)
def test_chunk_staging_covers_each_element_once(N):
    """The chunked kernel's staging maps, at its kChunk and kDBlock:
    thread tid stages x/dt elements e = tid + k * threads (k < kChunk *
    kDBlock / threads) and B/C elements e < kChunk * N the same way; each
    (t, j) and (t, n) of a chunk is staged exactly once.  The padded y
    rows take one write from each of a warp's 32 lanes on 32 distinct
    shared-memory banks."""
    G = N // launch_plan(SHORT_S + 1, N)[0]
    kT = D_BLOCK * G
    x_per, bc_per = CHUNK * D_BLOCK // kT, -(-CHUNK * N // kT)
    assert x_per * kT == CHUNK * D_BLOCK and CHUNK % G == 0
    xs = sorted((e // D_BLOCK, e % D_BLOCK) for tid in range(kT)
                for e in (tid + k * kT for k in range(x_per)))
    assert xs == [(t, j) for t in range(CHUNK) for j in range(D_BLOCK)]
    bc = sorted((e // N, e % N) for tid in range(kT)
                for e in (tid + k * kT for k in range(bc_per))
                if e < CHUNK * N)
    assert bc == [(t, n) for t in range(CHUNK) for n in range(N)]
    y_row = D_BLOCK + 32 // G
    for t in range(0, CHUNK, G):
        for warp in range(kT // 32):
            tids = range(32 * warp, 32 * warp + 32)
            banks = {((t + tid % G) * y_row + tid // G) % 32 for tid in tids}
            assert len(banks) == 32


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 16])
def test_chunk_ring_has_no_race_between_barriers(n_chunks):
    """The two-buffer ring as the kernel orders it: in the phase between
    barriers c - 1 and c every thread computes chunk c (reads the staged
    buffer c % 2, writes y buffer c % 2), stashes chunk c + 1 (writes the
    staged buffer (c + 1) % 2) and then writes out y of chunk c - 1 (reads
    y buffer (c - 1) % 2).  Threads of one phase may run in any order, so
    no buffer may be written in a phase in which it is also read or
    written elsewhere; each chunk is staged one phase before it is read."""
    phases = [[("staged", 0, "w")]]                    # the prologue
    for c in range(n_chunks):
        ph = [("staged", c % 2, "r"), ("y", c % 2, "w")]
        if c + 1 < n_chunks:
            ph.append(("staged", (c + 1) % 2, "w"))
        if c:
            ph.append(("y", (c - 1) % 2, "r"))
        phases.append(ph)
    phases.append([("y", (n_chunks - 1) % 2, "r")])    # after the last
    for ph in phases:
        written = {(a, i) for a, i, op in ph if op == "w"}
        read = {(a, i) for a, i, op in ph if op == "r"}
        assert not written & read and len(written) == sum(
            op == "w" for _, _, op in ph)
    for c in range(n_chunks):                          # staged, then read
        assert ("staged", c % 2, "w") in phases[c]
        assert ("staged", c % 2, "r") in phases[c + 1]
        assert ("y", c % 2, "r") in phases[c + 2]


def test_launch_plan_over_the_serve_shapes():
    """Decode ticks (S = 1) and multi-token decode up to SHORT_S take the
    direct kernel with 8 states a thread; the prefill buckets of 16-512
    tokens the chunked one with 2 (G = 8 lanes a d at N = 16)."""
    assert launch_plan(1, 16) == (8, False)
    assert launch_plan(SHORT_S, 16) == (8, False)
    assert launch_plan(SHORT_S + 1, 16) == (2, True)
    for S in (16, 96, 256, 400, 512):
        assert launch_plan(S, 16) == (2, True)
    with pytest.raises(ValueError):
        launch_plan(16, 12)


@pytest.mark.parametrize("N", STATE_SIZES)
def test_launch_plan_is_what_the_kernel_builds(N):
    """The kernel has one build a kernel for each N and refuses any other
    NG: launch_plan's NG is its kDirectNG and kChunkedNG, and G = N / NG
    lanes a d is a power of two a warp holds, at least 2 when chunked."""
    direct, chunked = launch_plan(1, N), launch_plan(SHORT_S + 1, N)
    assert direct == (_cu_ng("kDirectNG", N), False)
    assert chunked == (_cu_ng("kChunkedNG", N), True)
    for ng, ch in (direct, chunked):
        G = N // ng
        assert ng * G == N and G & (G - 1) == 0 and G <= 32
        assert G >= 2 or not ch


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("N", STATE_SIZES)
def test_schedule_matches_plain_with_h0(N, chunked):
    """Each build of the kernel (N, direct or chunked) from a stored
    state, at a D that is not a multiple of the block (70), S of 1, 2, 5
    and 8 (direct) or 9 and 33 (chunked, a ragged last chunk): against
    the port's plain version."""
    for S in ((1, 2, 5, SHORT_S) if not chunked else (SHORT_S + 1, 33)):
        assert launch_plan(S, N)[1] == chunked
        x, dt, Bm, Cm, A, h0 = _t(_inputs(2, S, 70, N, h0=True))
        y, h = scan_schedule(x, dt, Bm, Cm, A, h0)
        ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h0)
        _close(y, ry)
        _close(h, rh)


@pytest.mark.parametrize("B,S,D,N,bf16", [
    (1, 32, 64, 8, False),
    (2, 64, 128, 16, True),
    (1, 96, 64, 4, False),
    (1, 33, 96, 32, True),
])
def test_schedule_matches_pallas(B, S, D, N, bf16):
    """From zeros (the Pallas kernel has no h0): the launch plan's
    schedule against the Pallas kernel in interpret mode."""
    x, dt, Bm, Cm, A, _ = _inputs(B, S, D, N, bf16=bf16)
    jy, jh = j_scan(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)),
                    chunk=16, block_d=min(64, D), interpret=True)
    y, h = scan_schedule(*_t((x, dt, Bm, Cm, A)))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("B,S,D,N", [
    (8, 1, 128, 16),            # a decode tick
    (3, 5, 70, 8),              # multi-token decode, ragged D
    (2, 33, 100, 16),           # past SHORT_S from a stored state
    (1, 2, 64, 32),
])
def test_schedule_matches_jax_ref_with_h0(B, S, D, N):
    x, dt, Bm, Cm, A, h0 = _inputs(B, S, D, N, h0=True)
    jy, jh = j_scan_ref(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)),
                        h0=jnp.asarray(h0))
    y, h = scan_schedule(*_t((x, dt, Bm, Cm, A, h0)))
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("S", [17, 40])
def test_padded_steps_pass_the_state_through(S):
    """dt = 0 from step 10 on (the model's right padding) and the chunk's
    own padding: h after S steps equals h after the first 10, exactly."""
    x, dt, Bm, Cm, A, h0 = _t(_inputs(2, S, 64, 16, h0=True))
    dt[:, 10:] = 0.0
    _, h = scan_schedule(x, dt, Bm, Cm, A, h0)
    _, h10 = scan_schedule(x[:, :10], dt[:, :10], Bm[:, :10], Cm[:, :10],
                           A, h0)
    assert torch.equal(h, h10)


def test_bc_strides_read_views_where_they_lie():
    """Bm and Cm as views into a (B, S, R + 2N) projection, a slice of it
    in time and a batch-minor layout pass their batch and time strides to
    the kernel; a last stride other than 1 raises."""
    B, S, R, N = 3, 5, 24, 16
    W = R + 2 * N
    proj = torch.zeros((B, S, W), dtype=torch.bfloat16)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    assert bc_strides("Bm", Bm) == bc_strides("Cm", Cm) == (S * W, W)
    assert bc_strides("Bm", Bm[:, :2]) == (S * W, W)
    assert bc_strides("Bm", torch.zeros((B, S, N))) == (S * N, N)
    assert bc_strides("Bm", torch.zeros((S, B, N)).transpose(0, 1)) == (
        N, B * N)
    with pytest.raises(ValueError):
        bc_strides("Bm", torch.zeros((B, N, S)).transpose(1, 2))


def test_wrapper_reads_strided_bf16_bc_as_f32_copies():
    """Strided bf16 Bm/Cm (views of the projection) give the same y and h,
    bit for bit, as contiguous f32 copies of the same values."""
    B, S, D, R, N = 2, 7, 64, 8, 16
    x, dt, _, _, A, h0 = _t(_inputs(B, S, D, N, h0=True))
    proj = T(RNG.standard_normal((B, S, R + 2 * N)).astype(np.float32)).to(
        torch.bfloat16)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    y, h = selective_scan(x, dt.to(torch.bfloat16), Bm, Cm, A, h0)
    ry, rh = selective_scan(x, dt.to(torch.bfloat16).float(),
                            Bm.float().contiguous(), Cm.float().contiguous(),
                            A, h0)
    assert torch.equal(y, ry) and torch.equal(h, rh)


@pytest.mark.parametrize("N", STATE_SIZES)
def test_chunk_ring_fits_and_opts_in_past_48k(N):
    """The chunked kernel's ring (two chunks of dt, dt * x, B, C and the
    padded y rows, f32) in dynamic shared memory: within the 227 KB a
    block may take, and past the 48 KB default only at N = 64 (57 KB),
    where the launch opts in to the larger size first."""
    G = N // launch_plan(SHORT_S + 1, N)[0]
    ring = 4 * 2 * CHUNK * (2 * D_BLOCK + 2 * N + D_BLOCK + 32 // G)
    assert ring <= 232448
    assert (ring > 48 * 1024) == (N == 64)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in CU
    assert "extern __shared__" in CU


@pytest.mark.parametrize("S", [1, 3, SHORT_S + 1, 40])
def test_schedule_matches_plain_on_mamba2_inputs(S):
    """zamba2's recurrence through the scan (N = 64, channel d = (head,
    p)): dt and A of a head repeated over its P channels, from a stored
    state; the direct (decode, verify) and chunked (prefill) schedules
    against the plain version."""
    B, nh, P, N = 2, 3, 8, 64
    x, _, Bm, Cm, _, h0 = _t(_inputs(B, S, nh * P, N, h0=True))
    dt = T(np.abs(RNG.standard_normal((B, S, nh))).astype(np.float32) * 0.1)
    dt = dt[..., None].expand(B, S, nh, P).reshape(B, S, nh * P)
    A = -T(np.abs(RNG.standard_normal((nh,))).astype(np.float32) + 0.1)
    A = A[:, None, None].expand(nh, P, N).reshape(nh * P, N)
    assert launch_plan(S, N) == (8, S > SHORT_S)
    y, h = scan_schedule(x, dt, Bm, Cm, A, h0)
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h0)
    _close(y, ry)
    _close(h, rh)
