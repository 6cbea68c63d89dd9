"""PyTorch port: the schedules of the two attention kernels, emulated in
plain torch on the CPU and held to the port's plain versions and to the
JAX package's Pallas kernels (interpret mode).

- Paged attention cuts the KV axis into splits of whole 32-key stages
  (``split_plan``); a split past a row tile's last query position is not
  run, each live split keeps an f32 online softmax (masked keys -1e30), and
  the splits are merged by log-sum-exp.  The emulation follows the kernel
  split by split and stage by stage.
- Flash attention walks 64-key tiles for 64-row query tiles, skips a tile
  whose keys are all past the tile's last query position (causal; not
  causal it computes every tile and masks keys at negative positions), and
  rounds P to bf16 before P.V (scores, row sums and the accumulator stay
  f32), at hd 64, 80 (hubert, not causal), 96 and 128.
- Both at every built head dim, hd 96 (phi-3-vision) included: the paged
  kernel's lane of D = hd / 32 accumulator dims (3 at hd 96, read and
  stored one by one), its q lines (192 bf16 lines at hd 96 for 128
  threads: the second pass guarded) and key lines, with the constants
  and the dispatch read from ``paged_attention.cu``.

The CUDA kernels run only on the card (``test_torch_cuda.py`` and
``chip_smoke.py`` hold them to the same plain versions there); these tests
show that the schedules themselves are right."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.paged_attention import paged_attention as j_paged
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.kernel import \
    HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.paged_attention.kernel import (BLOCK_SIZES,
                                                        HEAD_DIMS,
                                                        MAX_STAGES,
                                                        ROWS_PER_CTA,
                                                        STAGE_KEYS,
                                                        split_plan)

from _torch_port import f32

RNG = np.random.default_rng(13)
T = torch.from_numpy
NEG_INF = -1e30
F32_TOL = 2e-5          # summation order only
BF16_TOL = 2e-2         # one bf16 step at |x| < 4, plus slack
TILE = 64               # the flash kernel's query rows and keys per tile
PAGED_CU = (_build.CSRC / "paged_attention.cu").read_text()
FLASH_CU = (_build.CSRC / "flash_attention.cu").read_text()
LANES = 32              # a warp's lanes: the paged kernel's P.V splits hd


def _cu_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))


PAGED_THREADS = 32 * _cu_const(PAGED_CU, "kWarps")


# ----------------------------------------------------------- paged, split-KV
def lane_scratch(acc):
    """The f32 partial row (rows, hd) that the lanes' stores write:
    ``store_f32<D>`` puts lane t's D values at t D, one float4 (D = 4), one
    float2 (D = 2) or D scalars (any other D).  Every column must be
    written exactly once."""
    rows, lanes, D = acc.shape
    out = torch.full((rows, lanes * D), float("nan"))
    width = D if D in (2, 4) else 1            # values of one store
    for t in range(lanes):
        for i in range(0, D, width):
            col = t * D + i
            assert torch.isnan(out[:, col:col + width]).all(), "overlap"
            out[:, col:col + width] = acc[:, t, i:i + width]
    assert not torch.isnan(out).any()
    return out


def paged_split_kv(q, k_pool, v_pool, tables, pos, *, ctx_cols=0,
                   n_sms=132):
    """The split-KV paged kernel's schedule in plain torch (f32 inside):
    returns (out in q's dtype, number of live splits per row tile).  Each
    split's accumulator is kept as the kernel's lanes keep it (lane t
    holds dims t D .. t D + D - 1, D = hd / 32) and its partial goes
    through an f32 scratch row written lane by lane, as the combine reads
    it; a head dim that no kernel builds (not a multiple of 32) is kept as
    one lane of hd."""
    B, S, H, hd = q.shape
    NB, bs, K, _ = k_pool.shape
    MB = tables.shape[1]
    n_vis = min(ctx_cols, MB) if ctx_cols else MB
    G, rows = H // K, S * (H // K)
    lanes = LANES if hd % LANES == 0 else 1
    tiles, n_split, split_keys = split_plan(B, S, H, K, bs, n_vis, n_sms)
    out = torch.empty((B, S, H, hd), dtype=torch.float32)
    live = []
    for b in range(B):
        cols = tables[b, :n_vis].long()
        for kh in range(K):
            kk = k_pool[cols, :, kh].reshape(n_vis * bs, hd).float()
            vv = v_pool[cols, :, kh].reshape(n_vis * bs, hd).float()
            r = torch.arange(rows)
            qr = q[b, r // G, kh * G + r % G].float()        # (rows, hd)
            qpos = int(pos[b]) + r // G
            for t in range(tiles):
                rr = slice(t * ROWS_PER_CTA, min((t + 1) * ROWS_PER_CTA, rows))
                end_key = min(n_vis * bs, int(qpos[rr][-1]) + 1)
                n_live = min(n_split, -(-end_key // split_keys))
                live.append(n_live)
                parts = []
                for sp in range(n_live):
                    k_end = min((sp + 1) * split_keys, end_key)
                    m = torch.full((qr[rr].shape[0],), NEG_INF)
                    l = torch.zeros_like(m)
                    acc = torch.zeros((m.shape[0], lanes, hd // lanes))
                    for k0 in range(sp * split_keys, k_end, STAGE_KEYS):
                        kv = torch.arange(k0, min(k0 + STAGE_KEYS, k_end))
                        s = qr[rr] @ kk[kv].T * hd ** -0.5
                        s = torch.where(kv[None] <= qpos[rr][:, None], s,
                                        NEG_INF)
                        mx = torch.maximum(m, s.max(1).values)
                        corr = torch.exp(m - mx)
                        p = torch.exp(s - mx[:, None])
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None, None] + torch.einsum(
                            "rk,kld->rld", p,
                            vv[kv].reshape(len(kv), lanes, -1))
                        m = mx
                    parts.append((m, l, lane_scratch(acc)))
                if n_live == 1:
                    m, l, acc = parts[0]
                    o = acc / l.clamp_min(1e-30)[:, None]
                else:                  # one pass, rescaling as M grows
                    M = torch.full_like(parts[0][0], NEG_INF)
                    L = torch.zeros_like(M)
                    A = torch.zeros_like(parts[0][2])
                    for m, l, acc in parts:
                        mx = torch.maximum(M, m)
                        c, w = torch.exp(M - mx), torch.exp(m - mx)
                        L = L * c + l * w
                        A = A * c[:, None] + acc * w[:, None]
                        M = mx
                    o = A / L.clamp_min(1e-30)[:, None]
                ri = r[rr]
                out[b, ri // G, kh * G + ri % G] = o
    return out.to(q.dtype), live


def _paged_case(B, S, H, K, hd, bs, MB, pos, pool_dtype, q_dtype):
    NB = B * MB + 1
    q = RNG.standard_normal((B, S, H, hd)).astype(np.float32)
    kp = RNG.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = RNG.standard_normal((NB, bs, K, hd)).astype(np.float32)
    bt = (RNG.permutation(NB - 1)[:B * MB].reshape(B, MB) + 1).astype(
        np.int32)
    for b, p in enumerate(pos):         # past the request's extent: trash
        bt[b, (p + S - 1) // bs + 1:] = 0
    return (T(q).to(q_dtype), T(kp).to(pool_dtype), T(vp).to(pool_dtype),
            T(bt), T(np.asarray(pos, np.int32)))


@pytest.mark.parametrize("B,S,H,K,bs,MB,pos,pool_dt,q_dt", [
    (4, 1, 4, 2, 16, 32, [0, 100, 300, 511], "float32", "float32"),
    (4, 1, 4, 2, 8, 64, [511, 3, 260, 64], "float32", "bfloat16"),
    (3, 1, 6, 2, 16, 32, [37, 500, 8], "bfloat16", "float32"),
    (2, 5, 4, 2, 8, 64, [400, 31], "bfloat16", "bfloat16"),
    (2, 9, 6, 2, 16, 32, [470, 120], "float32", "float32"),
])
def test_paged_split_kv_matches_plain_and_pallas(B, S, H, K, bs, MB, pos,
                                                 pool_dt, q_dt):
    """Contexts of up to 512 keys over up to 16 splits, some wholly in the
    future of a request (a split with nothing to see is not run), trash
    columns past every request's extent, S > 1, both block sizes, f32 and
    bf16 pools and queries: the split schedule equals the port's plain
    version and the Pallas kernel within 2e-5 for f32 queries (summation
    order only) and within one bf16 step for bf16 ones; cutting the
    visible prefix gives the same."""
    hd = 16
    q, kp, vp, bt, p = _paged_case(B, S, H, K, hd, bs, MB, pos,
                                   getattr(torch, pool_dt),
                                   getattr(torch, q_dt))
    tol = F32_TOL if q_dt == "float32" else BF16_TOL
    need = (max(pos) + S - 1) // bs + 1
    for cols in (0, need):
        w = cols or MB
        out, live = paged_split_kv(q, kp, vp, bt, p, ctx_cols=cols)
        ref = paged_attention_ref(q, kp, vp, bt[:, :w], p)
        ker = j_paged(jnp.asarray(f32(q)).astype(getattr(jnp, q_dt)),
                      jnp.asarray(f32(kp)).astype(getattr(jnp, pool_dt)),
                      jnp.asarray(f32(vp)).astype(getattr(jnp, pool_dt)),
                      jnp.asarray(bt.numpy()), jnp.asarray(p.numpy()),
                      ctx_cols=cols, interpret=True)
        np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)
        np.testing.assert_allclose(f32(out), f32(ker), atol=tol, rtol=tol)
        _, n_split, _ = split_plan(B, S, H, K, bs, w, 132)
        assert n_split > 1 and min(live) < n_split, (n_split, live)


def test_paged_combine_of_a_row_masked_in_its_split():
    """A row tile of S = 3 chunk rows whose split starts between the
    rows' positions: the first row sees nothing in that split (its
    partial is m = -1e30, l = the split's key count), and the merge gives
    it weight exp(-1e30 - M) = 0; the result equals the plain version."""
    B, S, H, K, hd, bs, MB = 1, 3, 2, 1, 16, 16, 8
    q, kp, vp, bt, p = _paged_case(B, S, H, K, hd, bs, MB, [63],
                                   torch.float32, torch.float32)
    _, n_split, split_keys = split_plan(B, S, H, K, bs, MB, 132)
    assert split_keys == STAGE_KEYS and 63 < 2 * split_keys <= 65
    out, live = paged_split_kv(q, kp, vp, bt, p)
    assert live == [3]                    # keys 0-31, 32-63, 64-65
    np.testing.assert_allclose(
        f32(out), f32(paged_attention_ref(q, kp, vp, bt, p)), atol=F32_TOL,
        rtol=F32_TOL)


@pytest.mark.parametrize("B,S,H,K,bs,n_vis,want", [
    (8, 1, 24, 2, 16, 33, (1, 9, 64)),     # the serve's decode tick
    (1, 64, 24, 2, 16, 22, (48, 4, 96)),   # suffix prefill S = 64
    (1, 96, 24, 2, 16, 64, (72, 11, 96)),
    (8, 1, 24, 2, 8, 1, (1, 1, 32)),
    (4, 3, 4, 2, 8, 128, (1, 16, 64)),
])
def test_split_plan(B, S, H, K, bs, n_vis, want):
    """Splits fill about one CTA per SM from n_vis alone; each is whole
    32-key stages, at most three, together they cover the visible keys,
    and none is empty."""
    tiles, n_split, split_keys = split_plan(B, S, H, K, bs, n_vis, 132)
    assert (tiles, n_split, split_keys) == want
    assert split_keys % STAGE_KEYS == 0
    assert split_keys <= MAX_STAGES * STAGE_KEYS
    assert (n_split - 1) * split_keys < n_vis * bs <= n_split * split_keys
    assert tiles == -(-S * H // K // ROWS_PER_CTA)


def paged_lines(hd, q_bytes, pool_bytes):
    """The paged kernel's loads at one head dim, from its index math: the
    (row, 16-byte line) of the tile's q that each thread's QITER loads
    reach (guarded by e < QLINES), and the (key, line) of a 32-key stage
    its KITER loads reach.  Returns (q lines, key lines, QITER x threads,
    QLINES)."""
    qe, le = 16 // q_bytes, 16 // pool_bytes
    q_lines = ROWS_PER_CTA * hd // qe
    qiter = -(-q_lines // PAGED_THREADS)
    lines = hd // le
    kiter = STAGE_KEYS * lines // PAGED_THREADS
    qs, ks = [], []
    for tid in range(PAGED_THREADS):
        for i in range(qiter):
            e = tid + i * PAGED_THREADS
            if e < q_lines:
                qs.append((e // (hd // qe), e % (hd // qe)))
        for i in range(kiter):
            e = tid + i * PAGED_THREADS
            ks.append((e // lines, e % lines))
    return qs, ks, qiter * PAGED_THREADS, q_lines


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("q_bytes,pool_bytes", [(2, 2), (2, 4), (4, 2),
                                                (4, 4)])
def test_paged_lanes_and_lines_cover_every_dim(hd, q_bytes, pool_bytes):
    """At every built head dim and dtype pair: the q loads cover the tile's
    16 rows x hd once each (at hd 96 in bf16, 192 lines for 128 threads:
    a second pass of which only 64 threads load, the rest guarded), the
    key loads a stage's 32 rows once each, a padded shared-memory row is
    whole 16-byte lines, and 32 lanes of D = hd / 32 dims hold hd."""
    qs, ks, slots, q_lines = paged_lines(hd, q_bytes, pool_bytes)
    qe, le = 16 // q_bytes, 16 // pool_bytes
    assert sorted(qs) == [(r, c) for r in range(ROWS_PER_CTA)
                          for c in range(hd // qe)]
    assert sorted(ks) == [(t, c) for t in range(STAGE_KEYS)
                          for c in range(hd // le)]
    assert slots >= q_lines and (slots > q_lines) == (
        hd == 96 and q_bytes == 2)
    assert ((hd + le) * pool_bytes) % 16 == 0     # row_ld: hd + one line
    assert hd % LANES == 0
    lane_scratch(torch.zeros((2, LANES, hd // LANES)))


def test_head_dims_are_the_kernels_builds():
    """The wrappers' HEAD_DIMS are what the sources dispatch: paged
    attention at every (hd, block size), the flash forward and backward at
    every hd, hubert's 80 among them (paged attention keeps its own: the
    encoder never decodes)."""
    built = set(re.findall(r"PORT_PAGED_CASE\((\d+), (\d+)\)", PAGED_CU))
    assert built == {(str(h), str(b)) for h in HEAD_DIMS for b in BLOCK_SIZES}
    bwd = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for src in (FLASH_CU, bwd):
        assert set(re.findall(r"hd == (\d+)\)", src)) == {
            str(h) for h in FLASH_HEAD_DIMS}
    assert 96 in HEAD_DIMS and 96 in FLASH_HEAD_DIMS
    assert 80 in FLASH_HEAD_DIMS and 80 not in HEAD_DIMS


@pytest.mark.parametrize("S,bs,pos,pool_dt,q_dt", [
    (1, 16, [0, 100, 300, 511], "float32", "bfloat16"),
    (1, 8, [511, 3, 260, 64], "bfloat16", "bfloat16"),
    (4, 16, [400, 31, 7, 200], "bfloat16", "float32"),
    (9, 8, [470, 120, 0, 33], "float32", "float32"),
])
def test_paged_split_kv_at_hd96_matches_plain_and_pallas(S, bs, pos,
                                                         pool_dt, q_dt):
    """phi-3-vision's head shape, MHA (G = 1) at hd 96, D = 3 dims a lane:
    the split schedule, its partials through the lanes' scalar stores,
    equals the plain version and the Pallas kernel (interpret mode) within
    2e-5 for f32 queries and one bf16 step for bf16 ones."""
    B, H, K, hd, MB = 4, 2, 2, 96, 512 // bs
    q, kp, vp, bt, p = _paged_case(B, S, H, K, hd, bs, MB, pos,
                                   getattr(torch, pool_dt),
                                   getattr(torch, q_dt))
    tol = F32_TOL if q_dt == "float32" else BF16_TOL
    out, live = paged_split_kv(q, kp, vp, bt, p)
    ref = paged_attention_ref(q, kp, vp, bt, p)
    ker = j_paged(jnp.asarray(f32(q)).astype(getattr(jnp, q_dt)),
                  jnp.asarray(f32(kp)).astype(getattr(jnp, pool_dt)),
                  jnp.asarray(f32(vp)).astype(getattr(jnp, pool_dt)),
                  jnp.asarray(bt.numpy()), jnp.asarray(p.numpy()),
                  interpret=True)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(out), f32(ker), atol=tol, rtol=tol)
    assert max(live) > 1


# ------------------------------------------------- flash, tensor-core tiles
def flash_tiles(q, k, v, qpos, kpos, *, causal=True):
    """The tensor-core flash kernel's schedule in plain torch: 64-row query
    tiles against 64-key tiles, tiles wholly past the query tile's last
    position skipped (causal; not causal, every tile runs and keys at
    negative positions are masked), f32 scores and online softmax, P
    rounded to bf16 for P.V, f32 accumulator; keys past Skv do not
    exist."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32)
    for b in range(B):
        for h in range(H):
            kk, vv = k[b, :, h // G].float(), v[b, :, h // G].float()
            for q0 in range(0, Sq, TILE):
                qs = q[b, q0:q0 + TILE, h].float()
                qp = qpos[b, q0:q0 + TILE]
                m = torch.full((qs.shape[0],), NEG_INF)
                l = torch.zeros_like(m)
                acc = torch.zeros((qs.shape[0], hd))
                for k0 in range(0, Skv, TILE):
                    kp = kpos[b, k0:k0 + TILE]
                    if causal and not bool((kp <= qp.max()).any()):
                        continue
                    s = qs @ kk[k0:k0 + TILE].T * hd ** -0.5
                    if causal:
                        s = torch.where(kp[None] <= qp[:, None], s, NEG_INF)
                    else:
                        s = torch.where(kp[None] >= 0, s, NEG_INF)
                    mx = torch.maximum(m, s.max(1).values)
                    corr = torch.exp(m - mx)
                    p = torch.exp(s - mx[:, None])
                    l = l * corr + p.sum(1)
                    acc = (acc * corr[:, None]
                           + p.bfloat16().float() @ vv[k0:k0 + TILE])
                    m = mx
                out[b, q0:q0 + TILE, h] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _bf16(shape):
    return T(RNG.standard_normal(shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,shift", [
    (1, 77, 77, 4, 2, 16, True, 0),      # ragged tails
    (1, 200, 200, 4, 1, 32, True, 0),    # MQA, four tiles
    (1, 50, 130, 4, 2, 16, False, 0),    # not causal, Sq != Skv
    (2, 150, 150, 6, 2, 16, True, 70),   # per-request positions
    (2, 40, 300, 4, 2, 16, True, 0),     # suffix queries over a longer kv
    (1, 130, 130, 4, 4, 96, True, 0),    # hd 96, MHA (phi-3-vision)
    (2, 70, 200, 2, 1, 96, True, 30),    # hd 96, MQA, shifted suffix
    (1, 64, 100, 2, 2, 96, False, 0),    # hd 96, not causal
    (1, 130, 130, 4, 4, 80, False, 0),   # hd 80, MHA, not causal (hubert)
    (2, 100, 250, 2, 1, 80, False, 0),   # hd 80, MQA, not causal, Sq != Skv
    (2, 150, 150, 2, 2, 80, True, 40),   # hd 80, causal, shifted
])
def test_flash_tiles_match_plain(B, Sq, Skv, H, K, hd, causal, shift):
    """The tiled schedule, with P in bf16, against the port's plain version
    (f32 P) within one bf16 step: ragged tails, skipped tiles, GQA/MQA,
    causal=False and two requests at different positions."""
    q, k, v = _bf16((B, Sq, H, hd)), _bf16((B, Skv, K, hd)), _bf16(
        (B, Skv, K, hd))
    qp = torch.arange(Sq) + (Skv - Sq)
    qp = torch.stack([qp - shift * b for b in range(B)]).clamp_min(0)
    kp = torch.arange(Skv).expand(B, Skv)
    out = flash_tiles(q, k, v, qp, kp, causal=causal)
    ref = attention_ref(q, k, v, qp, kp, causal=causal)
    np.testing.assert_allclose(f32(out), f32(ref), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("Sq,Skv,kv_start", [
    (128, 128, 0),       # the default causal alignment
    (128, 192, 96),      # rows 0..95 of the queries see no key at all
])
def test_flash_tiles_match_pallas_at_block_64(Sq, Skv, kv_start, H=4, K=2,
                                              hd=16, causal=True):
    """Against the Pallas kernel (interpret mode) at block_q = block_k = 64,
    which skips the same tiles: equal within one bf16 step, all-masked
    rows included — such a row averages V over the keys of the tiles its
    query tile visits (p = exp(-1e30 + 1e30) = 1), in both kernels; the
    plain version, which never skips, averages over all keys instead."""
    q, k, v = _bf16((1, Sq, H, hd)), _bf16((1, Skv, K, hd)), _bf16(
        (1, Skv, K, hd))
    qp = torch.arange(Sq) + (Skv - Sq if not kv_start else 0)
    kp = torch.arange(Skv) + kv_start
    out = flash_tiles(q, k, v, qp[None], kp[None], causal=causal)
    ker = j_flash(jnp.asarray(f32(q), jnp.bfloat16),
                  jnp.asarray(f32(k), jnp.bfloat16),
                  jnp.asarray(f32(v), jnp.bfloat16),
                  jnp.asarray(qp.numpy(), jnp.int32),
                  jnp.asarray(kp.numpy(), jnp.int32),
                  causal=causal, block_q=TILE, block_k=TILE, interpret=True)
    np.testing.assert_allclose(f32(out), f32(ker), atol=BF16_TOL,
                               rtol=BF16_TOL)
    if kv_start:
        dead = qp < kv_start                         # all keys masked
        ref = attention_ref(q, k, v, qp, kp)
        assert dead.any()
        np.testing.assert_allclose(f32(out)[0, ~dead], f32(ref)[0, ~dead],
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("Sq,Skv,H,K", [(192, 192, 4, 4), (100, 230, 2, 1)])
def test_flash_tiles_at_hd96_match_pallas(Sq, Skv, H, K):
    """phi-3-vision's head dim (6 k16 steps, 12 n8 tiles of the output a
    warp): the tiled schedule against the Pallas kernel (interpret mode)
    at block_q = block_k = 64, MHA and MQA, within one bf16 step."""
    test_flash_tiles_match_pallas_at_block_64(Sq, Skv, 0, H, K, hd=96)


@pytest.mark.parametrize("Sq,Skv,H,K", [(128, 128, 2, 2), (100, 230, 2, 1)])
def test_flash_tiles_at_hd80_not_causal_match_pallas(Sq, Skv, H, K):
    """hubert's head dim, not causal (5 k16 steps, 10 n8 tiles of the
    output a warp, every tile computed): the tiled schedule against the
    Pallas kernel (interpret mode) at block_q = block_k = 64, MHA and MQA,
    within one bf16 step."""
    test_flash_tiles_match_pallas_at_block_64(Sq, Skv, 0, H, K, hd=80,
                                              causal=False)


@pytest.mark.parametrize("B,S,H,K,start", [(2, 130, 2, 2, -30),
                                           (1, 100, 4, 1, -70)])
def test_flash_tiles_mask_negative_keys_when_not_causal(B, S, H, K, start):
    """Not causal at hd 80, keys at positions ``start`` .. S + start - 1:
    the keys at negative positions are masked (the whole first tile at
    -70), so the schedule equals the plain version and the model's CPU
    attention (``blocked_attention``, the JAX package's chunked attention)
    within one bf16 step, and a key at a negative position moves
    nothing."""
    from repro_torch.models.attention import blocked_attention
    q, k, v = _bf16((B, S, H, 80)), _bf16((B, S, K, 80)), _bf16(
        (B, S, K, 80))
    pos = (torch.arange(S) + start).expand(B, S)
    out = flash_tiles(q, k, v, pos, pos, causal=False)
    for ref in (attention_ref(q, k, v, pos, pos, causal=False),
                blocked_attention(q, k, v, causal=False, q_positions=pos,
                                  kv_positions=pos, k_chunk=64)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=BF16_TOL,
                                   rtol=BF16_TOL)
    v2 = v.clone()
    v2[:, :-start] = 100.0
    assert torch.equal(flash_tiles(q, k, v2, pos, pos, causal=False), out)


def test_flash_p_rounding_error_is_inside_the_bf16_output_step():
    """P in bf16 against P in f32 over the same tiles, at the serve's
    head width and a 320-token prompt: the difference stays well inside
    one bf16 step of the output, so the f32-P plain version remains the
    yardstick at 2e-2."""
    S, H, K, hd = 320, 2, 1, 128
    q, k, v = _bf16((1, S, H, hd)), _bf16((1, S, K, hd)), _bf16(
        (1, S, K, hd))
    pos = torch.arange(S)[None]
    out = flash_tiles(q, k, v, pos, pos).float()
    ref = attention_ref(q, k, v, pos, pos).float()
    assert float((out - ref).abs().max()) < BF16_TOL / 2
