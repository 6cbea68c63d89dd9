"""PyTorch port: the int8 quantize and dequantize kernels' schedule,
emulated in plain torch on the CPU and held to the port's plain versions,
to the JAX package's Pallas kernels (interpret mode) and to the JAX
engine's int8 path.

The quantizer (``csrc/quant.cu``) gives each block of ``block`` values to
a team: one warp up to kWarpBlockMax values, the whole CTA above.  Thread
t of a team holds vectors t, t + team, ... of kVecBytes each (4 f32 or 8
bf16 values), at most VPL of them, the smallest power of two that covers
the block; the team's max is each thread's max, then each warp's, then
the CTA's.  A block that is not a multiple of the vector width, a
misaligned pointer or a block beyond kCtaMaxVpl vectors a thread takes the
scalar kernel: a warp per block, lane l holding values l, l + 32, ....
The grid is the CTAs that fit on the card at once; teams stride over the
blocks and load block b + n_teams before they reduce block b.  The
dequantizer gives each lane kDqVals values and one scale and trades q words
between lanes by shuffles so that its 16-byte stores are contiguous across
the warp, or one value a thread (the scalar kernel) when the block is not a
multiple of kDqVals.  The CUDA
kernels run only on the card (``test_torch_cuda.py`` and ``chip_smoke.py``
hold them to the same plain versions there); these tests show that the
schedule itself is right."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.quant import dequantize as j_dequantize
from repro.kernels.quant import dequantize_ref as j_dequantize_ref
from repro.kernels.quant import quantize as j_quantize
from repro.kernels.quant import quantize_ref as j_quantize_ref
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.quant import (dequantize, dequantize_ref, quantize,
                                       quantize_ref)
from repro_torch.kernels.quant.kernel import is_one_value
from repro_torch.serving import ServingEngine

from _torch_port import dense_models

RNG = np.random.default_rng(15)
T = torch.from_numpy
# The kernel's own constants, read from its source so that these tests
# follow any change to them.
CU = (_build.CSRC / "quant.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


VEC_BYTES, CTA_THREADS = _cu_const("kVecBytes"), _cu_const("kCtaThreads")
WARP_BLOCK_MAX, CTA_MAX_VPL = (_cu_const("kWarpBlockMax"),
                               _cu_const("kCtaMaxVpl"))
DQ_VALS = _cu_const("kDqVals")
# K * hd of every configuration in the registry (starcoder2-3b 256,
# qwen3-moe 512, phi4-mini / qwen2 / mistral / llama4 1024, hubert 1280,
# zamba2 2048, phi-3-vision 3072), the reduced configs' 32 and 64, and a
# ragged block (a multiple of 4 f32 but not of 8 bf16)
BLOCKS = (32, 64, 256, 512, 1024, 1280, 2048, 3072, 36)
H100_SMS = 132


def plan(block, itemsize, aligned=True):
    """The host code's choice (``launch_quantize``): (team, VPL) of the
    vector kernel, or None for the scalar kernel."""
    V = VEC_BYTES // itemsize
    team = 32 if block <= WARP_BLOCK_MAX else CTA_THREADS
    vpl = -(-(block // V) // team)
    if block % V or team > 32 and vpl > CTA_MAX_VPL or not aligned:
        return None
    VPL = 1
    while VPL < vpl:                     # launch_vector's power of two
        VPL *= 2
    return team, VPL


def grid_blocks(n_blocks, team, n_sms, per_sm):
    """Blocks each team visits in the card-sized grid, and the blocks it
    loads (the first, then each next one before it reduces the current)."""
    teams_per_cta = CTA_THREADS // team
    grid = min(-(-n_blocks // teams_per_cta), n_sms * per_sm)
    n_teams = grid * teams_per_cta
    visits, loads = [], []
    for tm in range(n_teams):
        mine = list(range(tm, n_blocks, n_teams))
        visits += mine
        loads += mine[:1] + [b + n_teams for b in mine
                             if b + n_teams < n_blocks]
    return visits, loads


def holdings(block, itemsize, aligned=True):
    """(team, held): held[t] lists the block's values thread t of a team
    holds, padded with -1.  Vector kernel: vectors t, t + team, .. of V
    values each; scalar kernel: a warp, lane l holding l, l + 32, ...."""
    p = plan(block, itemsize, aligned)
    if p is None:
        rounds = -(-block // 32)
        held = torch.arange(rounds * 32).reshape(rounds, 32).T
        return 32, torch.where(held < block, held, -1)
    team, VPL = p
    V = VEC_BYTES // itemsize
    vec = torch.arange(VPL * team).reshape(VPL, team).T     # (t, j) -> i
    held = (vec[:, :, None] * V + torch.arange(V)).reshape(team, -1)
    return team, torch.where((vec < block // V).repeat_interleave(V, 1),
                             held, -1)


def quantize_schedule(x, u, block, aligned=True, n_sms=H100_SMS, per_sm=8):
    """The kernels' quantization in the order of their partition: each
    thread's max over the values it holds, each warp's, the team's, then
    each value quantized by the thread that holds it.  Returns (q,
    scales); asserts that each value and each scale is written once."""
    n = x.shape[0]
    nb = n // block
    team, held = holdings(block, x.element_size(), aligned)
    vals = held[held >= 0]
    assert sorted(vals.tolist()) == list(range(block))
    visits, loads = grid_blocks(nb, team, n_sms, per_sm)
    assert sorted(visits) == list(range(nb)) == sorted(loads)
    xb = x.float().reshape(nb, block)
    ub = u.float().expand(n).reshape(nb, block)
    pad = torch.cat([xb.abs(), torch.zeros(nb, 1)], dim=1)
    th = pad[:, torch.where(held >= 0, held, block)].amax(-1)   # (nb, team)
    warp = th.reshape(nb, team // 32, 32).amax(-1)             # shuffles
    amax = torch.clamp(warp.amax(-1), min=1e-12)               # shared memory
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.zeros(nb, block, dtype=torch.int8)
    scales = torch.zeros(nb)
    q_writes = torch.zeros(nb, block, dtype=torch.int32)
    s_writes = torch.zeros(nb, dtype=torch.int32)
    for blk in visits:
        s = xb[blk, vals] / scale[blk]
        lo = torch.floor(s)
        q[blk, vals] = torch.clamp(lo + (ub[blk, vals] < s - lo).float(),
                                   -127, 127).to(torch.int8)
        q_writes[blk, vals] += 1
        scales[blk] = scale[blk]
        s_writes[blk] += 1
    assert bool((q_writes == 1).all()) and bool((s_writes == 1).all())
    return q.reshape(n), scales


def dequantize_schedule(q, scales, block, out_dtype=torch.float32,
                        aligned=True):
    """The dequantizer's lanes: a warp loads 32 chunks of kDqVals int8 (one
    16-byte load and one scale a lane); store k of lane l holds values
    k * 32E + lE .. + E of the warp's chunks (E values a 16-byte store),
    whose q words and scale a shuffle brings from lane 2Ek + lE / 16.  The
    scalar kernel takes one value a thread.  Asserts that each value is
    written once."""
    n = q.shape[0]
    out = torch.zeros(n, dtype=out_dtype)
    writes = torch.zeros(n, dtype=torch.int32)
    if block % DQ_VALS or not aligned:
        i = torch.arange(n)
        out[i] = (q[i].float() * scales[i // block]).to(out_dtype)
        writes[i] += 1
        assert bool((writes == 1).all())
        return out
    E = VEC_BYTES // out.element_size()
    n_chunks = n // DQ_VALS
    words = q.view(torch.int32).reshape(n_chunks, 4)     # little-endian
    chunk_scale = scales[torch.arange(n_chunks) // (block // DQ_VALS)]
    lane = torch.arange(32)
    first = (E * lane // 4) % 4          # a lane's first word in its source
    for base in range(0, n_chunks, 32):  # one warp's chunks
        c = base + lane
        valid = c < n_chunks
        w = torch.zeros(32, 4, dtype=torch.int32)
        sc = torch.zeros(32)
        w[valid], sc[valid] = words[c[valid]], chunk_scale[c[valid]]
        for k in range(DQ_VALS // E):
            src = 2 * E * k + E * lane // 16                 # shuffle source
            got = torch.stack([w[src, first + m] for m in range(E // 4)], 1)
            vals = got.contiguous().view(torch.int8).float() * sc[src][:, None]
            pos = base * DQ_VALS + k * 32 * E + E * lane[:, None] \
                + torch.arange(E)
            ok = base + src < n_chunks
            out[pos[ok]] = vals[ok].to(out_dtype)
            writes[pos[ok]] += 1
    assert bool((writes == 1).all())
    return out


def _inputs(nb, block, x_dtype=torch.float32, one_u=False, seed=0):
    rng = np.random.default_rng(seed)
    x = T((rng.standard_normal(nb * block) * 3).astype(np.float32))
    x = x.to(x_dtype)
    u = (torch.full((1,), 0.5).expand(nb * block) if one_u
         else T(rng.random(nb * block).astype(np.float32)))
    return x, u


@pytest.mark.parametrize("block", BLOCKS)
def test_quant_schedule_matches_plain_and_pallas(block):
    """Every partition the host code can pick: f32 and bf16 x, random and
    one-value u, aligned (vector kernel) and misaligned (scalar kernel),
    bit-exact against the plain version.  f32 x with random u also against
    the Pallas kernels in interpret mode: XLA computes their scale as amax
    times 1/127, within one ulp of the IEEE division the kernel and the
    plain version make, so the scales agree within one ulp and q agrees
    exactly in every block whose scale is equal; dequantize (no division)
    agrees bit for bit on the Pallas kernel's own q and scales."""
    nb = 3
    for x_dtype in (torch.float32, torch.bfloat16):
        for one_u in (False, True):
            x, u = _inputs(nb, block, x_dtype, one_u, seed=block)
            rq, rs = quantize_ref(x, u, block=block)
            for aligned in (True, False):
                q, s = quantize_schedule(x, u, block, aligned)
                assert torch.equal(q, rq) and torch.equal(s, rs), (
                    x_dtype, one_u, aligned)
    x, u = _inputs(nb, block, seed=block + 1)
    jq, js = j_quantize(jnp.asarray(x.numpy()), jnp.asarray(u.numpy()),
                        block=block, interpret=True)
    jq, js = np.array(jq), np.array(js)
    q, s = quantize_schedule(x, u, block)
    np.testing.assert_array_max_ulp(s.numpy(), js, maxulp=1)
    same = np.repeat(s.numpy() == js, block)
    np.testing.assert_array_equal(q.numpy()[same], jq[same])
    jx = np.asarray(j_dequantize(jnp.asarray(jq), jnp.asarray(js),
                                 block=block, interpret=True))
    for aligned in (True, False):
        np.testing.assert_array_equal(
            dequantize_schedule(T(jq), T(js), block,
                                aligned=aligned).numpy(), jx)


@pytest.mark.parametrize("block", BLOCKS)
def test_dequant_schedule_bf16_out(block):
    """bf16 out: the f32 product rounded to nearest even, as the plain
    version's cast of its f32 result."""
    x, u = _inputs(4, block, seed=block + 2)
    q, s = quantize_ref(x, u, block=block)
    want = dequantize_ref(q, s, block=block).to(torch.bfloat16)
    for aligned in (True, False):
        out = dequantize_schedule(q, s, block, torch.bfloat16, aligned)
        assert out.dtype == torch.bfloat16 and torch.equal(out, want)
    assert torch.equal(dequantize_ref(q, s, block=block,
                                      out_dtype=torch.bfloat16), want)


@pytest.mark.parametrize("block,n_sms,per_sm", [
    (256, 1, 1), (256, 1, 3), (32, 1, 2), (2048, 1, 1), (3072, 2, 1),
    (36, 1, 1)])
def test_card_sized_grid_strides_over_every_block(block, n_sms, per_sm):
    """A card far smaller than the data: each team visits several blocks,
    loads each once (the next before it reduces the current), and the
    result is unchanged."""
    nb = 41
    x, u = _inputs(nb, block, seed=7)
    team = holdings(block, 4)[0]
    visits, _ = grid_blocks(nb, team, n_sms, per_sm)
    teams = n_sms * per_sm * CTA_THREADS // team
    assert len(visits) == nb and teams < nb
    q, s = quantize_schedule(x, u, block, n_sms=n_sms, per_sm=per_sm)
    rq, rs = quantize_ref(x, u, block=block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(dequantize_schedule(q, s, block),
                       dequantize_ref(q, s, block=block))


def test_plan_covers_every_registry_block():
    """Every registry block takes the vector kernel when aligned, in f32
    and bf16: a warp up to kWarpBlockMax values, a CTA above with at most
    kCtaMaxVpl vectors a thread; the ragged block of 36 takes the scalar
    kernel in bf16 only, and a block past a CTA's registers in both."""
    for block in BLOCKS[:-1]:
        for itemsize in (4, 2):
            team, VPL = plan(block, itemsize)
            assert team == (32 if block <= WARP_BLOCK_MAX else CTA_THREADS)
            V = VEC_BYTES // itemsize
            assert (VPL // 2) * team * V < block <= VPL * team * V
            assert team == 32 or VPL <= CTA_MAX_VPL
    assert plan(36, 4) == (32, 1) and plan(36, 2) is None
    cta_most = CTA_MAX_VPL * CTA_THREADS * VEC_BYTES      # bytes of x
    assert plan(cta_most // 4, 4) and plan(cta_most // 4 + 4, 4) is None
    assert plan(cta_most // 2, 2) and plan(cta_most // 2 + 8, 2) is None


def test_zero_values():
    """n = 0: nothing to write, and the wrappers return empty tensors."""
    x, u = torch.zeros(0), torch.zeros(0)
    q, s = quantize_schedule(x, u, 256)
    assert q.numel() == 0 and s.numel() == 0
    before = dict(LAUNCHES)
    q, s = quantize(x, u, block=256)
    assert q.shape == (0,) and s.shape == (0,) and q.dtype == torch.int8
    assert dequantize(q, s, block=256, out_dtype=torch.bfloat16).shape == (0,)
    assert dict(LAUNCHES) == before


def test_plain_inputs_where_they_lie():
    """bf16 x equals its f32 widening; u of one value expanded (stride 0)
    equals the full tensor of it, and the wrapper recognises exactly that
    form; bf16 out equals the f32 out's cast."""
    x, u = _inputs(6, 256, torch.bfloat16, seed=3)
    assert all(torch.equal(a, b) for a, b in zip(
        quantize(x, u, block=256), quantize(x.float(), u, block=256)))
    one = torch.full((1,), 0.5).expand(x.shape[0])
    assert is_one_value(one) and not is_one_value(u)
    assert not is_one_value(torch.full((x.shape[0],), 0.5))
    assert not is_one_value(torch.rand(2 * x.shape[0])[::2])
    q, s = quantize(x, one, block=256)
    rq, rs = quantize(x, torch.full((x.shape[0],), 0.5), block=256)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(dequantize(q, s, block=256, out_dtype=torch.bfloat16),
                       dequantize(q, s, block=256).to(torch.bfloat16))


@settings(max_examples=20, deadline=None)
@given(nb=st.integers(1, 5), log_scale=st.floats(-6.0, 6.0),
       seed=st.integers(0, 2 ** 31 - 1), one_u=st.booleans(),
       bf16=st.booleans(), block=st.sampled_from((32, 36, 64, 256, 1280)))
def test_schedule_property_bit_exact(nb, log_scale, seed, one_u, bf16,
                                     block):
    """Any magnitude, any input form: the schedule equals the plain
    version and its dequantization round-trips within half a step."""
    rng = np.random.default_rng(seed)
    x = T((rng.standard_normal(nb * block) * 10.0 ** log_scale)
          .astype(np.float32))
    x = x.to(torch.bfloat16) if bf16 else x
    u = (torch.full((1,), 0.5).expand(nb * block) if one_u
         else T(rng.random(nb * block).astype(np.float32)))
    q, s = quantize_schedule(x, u, block, n_sms=1, per_sm=1)
    rq, rs = quantize_ref(x, u, block=block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    back = dequantize_schedule(q, s, block)
    assert torch.equal(back, dequantize_ref(q, s, block=block))
    err = (back - x.float()).abs().reshape(nb, block)
    assert bool((err <= s[:, None] * (1.0 if not one_u else 0.5) * 1.0001
                 ).all())


@pytest.fixture(scope="module")
def models():
    return dense_models(0)


@pytest.mark.parametrize("cache_dtype", ["bf16", "f32"])
def test_engine_quant_exec_matches_jax_engine(models, cache_dtype):
    """The engine's int8 round trip on bf16 KV rows (L, n, K, hd), read in
    place with u of one value and returned in the pool's dtype, equals the
    JAX engine's composition (f32 quantize_ref, dequantize_ref, then the
    pool write's cast) bit for bit.  The JAX engine jits that composition,
    and XLA turns its division by 127 into a multiply by the reciprocal,
    so against the jitted callable a scale may differ by one f32 ulp: the
    values agree within one ulp of the pool's dtype."""
    cfg, tcfg, jp, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=2, block_size=8,
                   quant="int8", cache_dtype=cache_dtype)
    je = JEngine(jp, cfg, setting, max_seq=32)
    te = ServingEngine(tp, tcfg, setting, max_seq=32, device="cpu")
    n = 16
    block = cfg.n_kv_heads * cfg.hd
    rows = (RNG.standard_normal((cfg.n_layers, n, cfg.n_kv_heads, cfg.hd))
            * 2).astype(np.float32)
    kv = T(rows).to(torch.bfloat16)
    got = te._quant_exec(n)(kv)
    pool_dt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    assert got.dtype == pool_dt and got.shape == kv.shape
    flat = jnp.asarray(kv.float().numpy()).reshape(-1)
    jq, js = j_quantize_ref(flat, jnp.full(flat.shape, 0.5, jnp.float32),
                            block=block)
    want = np.array(j_dequantize_ref(jq, js, block=block))
    assert torch.equal(got, T(want).reshape(kv.shape).to(pool_dt))
    jit = np.array(je._quant_exec(n)(jnp.asarray(kv.float().numpy())
                                       .astype(jnp.bfloat16)))
    np.testing.assert_allclose(
        got.float().numpy(), T(jit).to(pool_dt).float().numpy(), atol=0,
        rtol=2.0 ** -22 if cache_dtype == "f32" else 2.0 ** -7)
