"""PyTorch port: the flash-attention backward on the CPU.

The plain backward (autograd through ``attention_ref``, what
``flash_attention_bwd`` runs for CPU tensors) against XLA's autodiff of
the JAX package's ``chunked_attention`` (whose kv block is
``jax.checkpoint``-ed), at group sizes G = 1, 2 and 12, causal and not,
ragged lengths, hd 80 (hubert, not causal) and 96.

Then the backward kernel's schedule (``csrc/flash_attention_bwd.cu``)
emulated in plain torch and held to the plain version.  The dq pass
first: one 64-query tile of a head at a time, delta = rowsum(dO * O) taken
from its own rows, dQ summed in f32 over the 64-key tiles its rows see,
with P recomputed from the forward's log-sum-exp and dS rounded to bf16.  Then the dk/dv pass: the G query
heads of a kv head split over P CTAs of a cluster (P the largest divisor
of G up to kMaxSplit), each CTA summing dK / dV of its 64 keys in f32 over
its own heads and the query tiles that see its keys, kDkvWidth queries at
a time (P rounded to bf16 for dV, dS for dK), and the P partials added in
rank order.  At a head dim that is not whole 64-column TMA boxes (hd 96,
phi-3-vision; hd 80, hubert) a tile holds hd rounded up to 64 columns,
the rest zeros:
the schedule runs its products over the padded tiles and stores hd
columns.  The tile sizes, widths and split are read from the kernel's
source.  The CUDA kernel runs only on the card
(``test_torch_cuda_train.py`` and ``chip_smoke.py`` hold it to the same
plain version there)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as j_chunked_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention.kernel import \
    HEAD_DIMS as FLASH_HEAD_DIMS

from _torch_port import f32

CU = (_build.CSRC / "flash_attention_bwd.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


BLOCK_Q, BLOCK_K = _cu_const("kBlockQ"), _cu_const("kBlockK")
DKV_WIDTH = _cu_const("kDkvWidth")
MAX_SPLIT = _cu_const("kMaxSplit")
NEG_INF = -1e30
# A gradient, port against XLA or the schedule against the plain version,
# relative to its largest |value|: the JAX attention rounds P to bf16 for
# P.V where the plain version keeps f32; the schedule rounds P (dV) and dS
# (dQ, dK) to bf16 for its products; every gradient is rounded to bf16.
GRAD_RTOL = 2e-2


def _inputs(B, Sq, Skv, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    return r(B, Sq, H, hd), r(B, Skv, K, hd), r(B, Skv, K, hd), r(B, Sq, H,
                                                                  hd)


def _rel(got, want):
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_grads(q, k, v, do, qp, kp, causal, k_chunk):
    def loss(q, k, v):
        out = j_chunked_attention(q, k, v, causal=causal, q_positions=qp,
                                  kv_positions=kp, k_chunk=k_chunk)
        return (out.astype(jnp.float32) * dout).sum()

    j = [jnp.asarray(f32(t), jnp.bfloat16) for t in (q, k, v)]
    dout = jnp.asarray(f32(do), jnp.float32)
    return jax.grad(loss, argnums=(0, 1, 2))(*j)


@pytest.mark.parametrize("B,S,H,K,hd,causal,k_chunk", [
    (1, 96, 2, 2, 16, True, 32),       # G = 1
    (1, 80, 2, 2, 96, True, 32),       # G = 1 at phi-3-vision's hd 96
    (2, 77, 4, 2, 16, True, 64),       # G = 2, ragged (k_chunk halves to 7)
    (1, 128, 12, 1, 32, True, 64),     # G = 12, the model's group size
    (1, 64, 24, 2, 16, True, 1024),    # G = 12 at the model's head counts
    (2, 50, 4, 2, 16, False, 32),      # not causal
    (1, 100, 12, 1, 16, False, 64),    # G = 12, not causal, ragged
    (1, 100, 2, 2, 80, False, 32),     # G = 1 at hubert's hd 80, not causal
    (2, 70, 4, 4, 80, False, 64),      # hd 80, not causal, ragged
])
def test_plain_backward_matches_xla_autodiff(B, S, H, K, hd, causal,
                                             k_chunk):
    q, k, v, do = _inputs(B, S, S, H, K, hd, seed=S)
    pos = torch.arange(S)[None].expand(B, S)
    jpos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = _jax_grads(q, k, v, do, jpos, jpos, causal, k_chunk)
    got = attention_bwd_ref(q, k, v, do, pos, pos, causal=causal)
    via_wrapper = flash_attention_bwd(q, k, v, attention_ref(q, k, v, pos,
                                                             pos),
                                      do, None, pos, pos, causal=causal)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, via_wrapper):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, c), name            # the wrapper's CPU path
        assert _rel(a, b) <= GRAD_RTOL, (name, _rel(a, b))


def test_cpu_forward_returns_the_plain_lse():
    q, k, v, _ = _inputs(2, 40, 40, 4, 2, 16)
    pos = torch.arange(40)[None].expand(2, 40)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    assert torch.equal(out, attention_ref(q, k, v, pos, pos))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(2, dim=2).float()) * 16 ** -0.5
    s = torch.where(pos[:, None, :, None] >= pos[:, None, None, :], s,
                    NEG_INF)
    np.testing.assert_allclose(f32(lse), f32(torch.logsumexp(s, -1)),
                               rtol=1e-6)
    assert lse.shape == (2, 4, 40)


# ------------------------------------------------------------- the schedule
def _bounds(pos, n, tile):
    """Each tile's min and max position (the kernel's tile_bounds)."""
    return ([int(pos[t:t + tile].min()) for t in range(0, n, tile)],
            [int(pos[t:t + tile].max()) for t in range(0, n, tile)])


def tile_cols(hd):
    """The kernel's tile_cols: a tile's columns, hd in whole 64-column
    TMA boxes (zeros past hd)."""
    return -(-hd // 64) * 64


def head_split(G):
    """The kernel's head_split: the CTAs that split a group of G heads."""
    return max(p for p in range(1, min(G, MAX_SPLIT) + 1) if G % p == 0)


def bwd_schedule(q, k, v, do, qpos, kpos, *, causal=True):
    """dq, dk, dv as the two kernels compute them (plain torch, f32
    accumulators, bf16 operands of the tensor-core products), over tiles
    of ``tile_cols(hd)`` columns: q, k, v and dout zero past hd, as TMA
    fills them; delta from hd columns of dout and out; hd columns
    stored."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    P = head_split(G)
    scale = hd ** -0.5
    out = attention_ref(q, k, v, qpos, kpos, causal=causal)
    lse = attention_lse_ref(q, k, qpos, kpos, causal=causal)    # (B, H, Sq)
    delta = torch.empty((B, H, Sq))
    for b in range(B):
        delta[b] = (do[b].float() * out[b].float()).sum(-1).T
    hdp = tile_cols(hd)
    q, k, v, do = (torch.nn.functional.pad(t, (0, hdp - hd))
                   for t in (q, k, v, do))
    dq = torch.zeros((B, Sq, H, hdp))
    dk = torch.zeros((B, Skv, K, hdp))
    dv = torch.zeros((B, Skv, K, hdp))

    def p_and_ds(qs, ks, vs, dos, ls, dl, qp, kp):
        """P (f32) and dS over a (queries x keys) block, masked by position."""
        s = qs.float() @ ks.float().T
        p = torch.exp(s * scale - ls[:, None])
        if causal:
            p = torch.where(kp[None, :] <= qp[:, None], p, 0.0)
        else:
            p = torch.where(kp[None, :] >= 0, p, 0.0)
        dp = dos.float() @ vs.float().T
        return p, p * (dp - dl[:, None])

    for b in range(B):
        qtmin, qtmax = _bounds(qpos[b], Sq, BLOCK_Q)
        ktmin, ktmax = _bounds(kpos[b], Skv, BLOCK_K)
        # the dq pass: one CTA per (head, 64-query tile); its prologue takes
        # delta for its own rows, then it walks the kv tiles its rows see
        for h in range(H):
            kh = h // G
            for t, q0 in enumerate(range(0, Sq, BLOCK_Q)):
                sl = slice(q0, min(q0 + BLOCK_Q, Sq))
                acc = torch.zeros((sl.stop - sl.start, hdp))
                for j, k0 in enumerate(range(0, Skv, BLOCK_K)):
                    if causal and ktmin[j] > qtmax[t]:
                        continue
                    ksl = slice(k0, min(k0 + BLOCK_K, Skv))
                    _, ds = p_and_ds(q[b, sl, h], k[b, ksl, kh],
                                     v[b, ksl, kh], do[b, sl, h],
                                     lse[b, h, sl], delta[b, h, sl],
                                     qpos[b, sl], kpos[b, ksl])
                    acc += ds.bfloat16().float() @ k[b, ksl, kh].float()
                dq[b, sl, h] = acc * scale
        # the dk/dv pass: a cluster of P CTAs per (kv head, 64-key tile),
        # rank r summing heads kh G + r G / P ... over the visible query
        # tiles; the partials added in rank order
        for kh in range(K):
            for k0 in range(0, Skv, BLOCK_K):
                ks, vs = k[b, k0:k0 + BLOCK_K, kh], v[b, k0:k0 + BLOCK_K, kh]
                kp = kpos[b, k0:k0 + BLOCK_K]
                vis = [t for t in range(len(qtmax))
                       if not (causal and qtmax[t] < int(kp.min()))]
                sum_k = torch.zeros((ks.shape[0], hdp))
                sum_v = torch.zeros((ks.shape[0], hdp))
                for r in range(P):
                    dka = torch.zeros((ks.shape[0], hdp))
                    dva = torch.zeros((ks.shape[0], hdp))
                    for h in range(kh * G + r * (G // P),
                                   kh * G + (r + 1) * (G // P)):
                        for t in vis:
                            for c0 in range(t * BLOCK_Q,
                                            min(t * BLOCK_Q + BLOCK_Q, Sq),
                                            DKV_WIDTH):
                                sl = slice(c0, min(c0 + DKV_WIDTH, Sq))
                                p, ds = p_and_ds(
                                    q[b, sl, h], ks, vs, do[b, sl, h],
                                    lse[b, h, sl], delta[b, h, sl],
                                    qpos[b, sl], kp)
                                dva += (p.T.bfloat16().float()
                                        @ do[b, sl, h].float())
                                dka += (ds.T.bfloat16().float()
                                        @ q[b, sl, h].float())
                    sum_k += dka
                    sum_v += dva
                dk[b, k0:k0 + BLOCK_K, kh] = sum_k * scale
                dv[b, k0:k0 + BLOCK_K, kh] = sum_v
    for t in (dq, dk, dv):                    # the padded columns stay 0
        assert not t[..., hd:].any()
    return tuple(t[..., :hd].bfloat16() for t in (dq, dk, dv))


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,shift", [
    (1, 77, 77, 4, 2, 16, True, 0),      # ragged tails, G = 2
    (1, 130, 130, 12, 1, 16, True, 0),   # G = 12, three tiles; P = 4 < G
    (1, 50, 130, 4, 2, 16, False, 0),    # not causal, Sq != Skv
    (2, 150, 150, 2, 2, 16, True, 70),   # G = 1, per-request positions
    (2, 40, 300, 4, 2, 16, True, 0),     # suffix queries over a longer kv
    (1, 96, 96, 6, 2, 16, True, 0),      # G = 3: P = 3
    (2, 70, 70, 12, 2, 16, True, 30),    # G = 6: P = 3 < G, shifted
    (1, 100, 100, 8, 1, 16, False, 0),   # G = 8: P = 4 < G, not causal
    (1, 130, 130, 2, 2, 96, True, 0),    # hd 96 (tiles of 128 columns), G = 1
    (2, 70, 70, 4, 2, 96, True, 30),     # hd 96, G = 2: P = 2, shifted
    (1, 50, 130, 6, 1, 96, False, 0),    # hd 96, G = 6: P = 3, not causal
    (1, 130, 130, 2, 2, 80, False, 0),   # hd 80 (hubert), G = 1, not causal
    (2, 70, 200, 2, 1, 80, False, 0),    # hd 80, G = 2: P = 2, not causal
    (1, 77, 77, 4, 4, 80, True, 0),      # hd 80, causal, ragged
])
def test_backward_schedule_matches_plain(B, Sq, Skv, H, K, hd, causal, shift):
    q, k, v, do = _inputs(B, Sq, Skv, H, K, hd, seed=Sq + Skv)
    qp = torch.arange(Sq) + (Skv - Sq)
    qp = torch.stack([qp - shift * b for b in range(B)]).clamp_min(0)
    kp = torch.arange(Skv).expand(B, Skv)
    got = bwd_schedule(q, k, v, do, qp, kp, causal=causal)
    want = attention_bwd_ref(q, k, v, do, qp, kp, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GRAD_RTOL, (name, _rel(a, b))
    if causal:
        # a key no query sees gets exactly nothing
        unseen = kp[0] > qp.max()
        assert not got[1][:, unseen].any() and not got[2][:, unseen].any()


@pytest.mark.parametrize("S,start", [(130, -30), (100, -70)])
def test_backward_schedule_masks_negative_keys_when_not_causal(S, start):
    """Not causal at hd 80, keys at positions ``start`` .. S + start - 1:
    the schedule's gradients equal the plain version's (which masks keys
    at negative positions, as the model's chunked attention does), and
    such a key gets exactly no dk and dv."""
    q, k, v, do = _inputs(1, S, S, 2, 2, 80, seed=S)
    pos = (torch.arange(S) + start)[None]
    got = bwd_schedule(q, k, v, do, pos, pos, causal=False)
    want = attention_bwd_ref(q, k, v, do, pos, pos, causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= GRAD_RTOL, (name, _rel(a, b))
    assert not got[1][:, :-start].any() and not got[2][:, :-start].any()


def test_schedule_constants_are_the_kernels():
    """The tiles, widths and head split the kernels use, and what the
    design rests on: a consumer warpgroup owns wgmma's 64 rows, the dk/dv
    width is whole k16 steps of a tile, two launches, no float atomics."""
    assert BLOCK_Q == BLOCK_K == 64
    assert DKV_WIDTH % 16 == 0 and BLOCK_Q % DKV_WIDTH == 0
    assert re.search(r"constexpr int kConsumers = 128;", CU)
    assert [head_split(G) for G in (1, 2, 3, 6, 8, 12)] == [1, 2, 3, 3, 4, 4]
    assert MAX_SPLIT <= 8                   # a portable cluster
    # the dk/dv pass fills the card at the training shape (B=4, S=512, K=2)
    assert (512 // BLOCK_K) * 2 * 4 * head_split(12) >= 132
    assert CU.count("<<<") + CU.count("cudaLaunchKernelEx(&") == 2
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in hopper and "cp.async.bulk.tensor" in hopper
    for atomic in ("atomicAdd", "red.global", "atom.global", "cp.reduce"):
        assert atomic not in CU and atomic not in hopper   # deterministic


def test_padded_tiles_are_the_kernels():
    """The backward builds every head dim the forward does; a tile's
    columns are hd in whole 64-column boxes (``tile_cols``: 128 at hd 80
    and 96, two boxes, the second partly outside the tensor and
    zero-filled by TMA, whose map's inner dimension is the true hd);
    products over hd take hd / 16 k16 steps (at hd 80 the fifth starts at
    the second box's base), and dq, dk, dv are stored at hd columns."""
    assert set(re.findall(r"hd == (\d+)\)", CU)) == {
        str(h) for h in FLASH_HEAD_DIMS}
    assert "return (hd + 63) / 64 * 64;" in CU
    assert [tile_cols(h) for h in FLASH_HEAD_DIMS] == [64, 128, 128, 128]
    # kmajor: k16 step kk of a row starts (kk / 4) boxes in
    assert "tile + (kk / 4) * kBox + row0 * 128 + (kk % 4) * 32" in CU
    assert "const cuuint32_t box[4] = {64, 1, 64, 1};" in CU
    assert "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE" in CU       # zero fill
    assert CU.count("kk < HD / 16; ++kk") == 4            # S, dP twice
    assert CU.count("n < HD / 8; ++n") == 2               # dq; dk/dv
    assert "N4 = kBlockK * HD / 4" in CU
