"""PyTorch port on the card: each CUDA kernel against its plain version,
the paged decode step against the gather path, and short serves through
the kernels (dense and ssm).  Every test here needs an NVIDIA GPU and
skips without one; ``python3 chip_smoke.py`` runs the same checks at full
width."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.kernels.mamba_scan.kernel import SHORT_S, launch_plan
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.quant import (dequantize, dequantize_ref, quantize,
                                       quantize_ref)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
from repro_torch.serving import serve_loop
from repro_torch.serving.workload import make_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("S,bs,q_dt,pool_dt", [
    (1, 16, torch.bfloat16, torch.bfloat16),
    (1, 8, torch.bfloat16, torch.float32),
    (37, 16, torch.float32, torch.float32),
    (5, 8, torch.float32, torch.bfloat16),
])
def test_paged_kernel_matches_plain(dev, S, bs, q_dt, pool_dt):
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, K, hd, MB = 3, 24, 2, 128, 8
    NB = B * MB + 1
    q = _randn(g, (B, S, H, hd), dev, q_dt)
    kp, vp = (_randn(g, (NB, bs, K, hd), dev, pool_dt) for _ in range(2))
    bt = torch.randint(0, NB, (B, MB), generator=g, device=dev,
                       dtype=torch.int32)
    bt[:, -2:] = 0                                  # stale rows: trash block
    pos = torch.tensor([0, bs * 3 - 1, MB * bs - S], dtype=torch.int32,
                       device=dev)
    for cols in (0, MB - 1):
        out = paged_attention(q, kp, vp, bt, pos, ctx_cols=cols)
        torch.cuda.synchronize()
        w = cols or MB
        ref = paged_attention_ref(q, kp, vp, bt[:, :w], pos)
        # f32 output: summation order only; bf16 output: one bf16 step
        tol = 2e-5 if q_dt == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("S,bs,hd,q_dt,pool_dt", [
    (1, 16, 128, torch.bfloat16, torch.bfloat16),
    (1, 8, 128, torch.bfloat16, torch.float32),
    (1, 8, 64, torch.float32, torch.bfloat16),
    (3, 16, 64, torch.float32, torch.float32),
    (64, 16, 128, torch.bfloat16, torch.bfloat16),
])
def test_paged_kernel_many_splits(dev, S, bs, hd, q_dt, pool_dt):
    """Long contexts (up to 1,000 tokens) cut into many KV splits, some of
    them wholly in the future of a request, with trash-block columns past
    each request's extent: the split kernel and its in-launch combine
    against the plain version, twice in a row (the counters must come back
    to zero), with the visible prefix cut too."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, K = 4, 24, 2
    MB = 1024 // bs
    NB = B * MB + 1
    q = _randn(g, (B, S, H, hd), dev, q_dt)
    kp, vp = (_randn(g, (NB, bs, K, hd), dev, pool_dt) for _ in range(2))
    bt = (torch.randperm(NB - 1, generator=g, device=dev)[:B * MB]
          .reshape(B, MB) + 1).to(torch.int32)
    pos = torch.tensor([0, 137, 600, 1000 - S], dtype=torch.int32,
                       device=dev)
    for b, p in enumerate(pos.tolist()):        # stale columns: trash block
        bt[b, (p + S - 1) // bs + 1:] = 0
    tol = 2e-5 if q_dt == torch.float32 else 2e-2
    for cols in (0, 0, (1000 - 1) // bs + 1):
        out = paged_attention(q, kp, vp, bt, pos, ctx_cols=cols)
        torch.cuda.synchronize()
        ref = paged_attention_ref(q, kp, vp, bt[:, :cols or MB], pos)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("S,kc", [(128, 128), (200, 256), (37, 128)])
def test_flash_kernel_matches_plain(dev, S, kc):
    g = torch.Generator(device=dev).manual_seed(1)
    q = _randn(g, (1, S, 24, 128), dev, torch.bfloat16)
    k, v = (_randn(g, (1, S, 2, 128), dev, torch.bfloat16) for _ in range(2))
    out = flash_attention(q, k, v, block_k=kc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", [
    (1, 77, 77, 8, 2, 64, True),       # hd 64, ragged
    (1, 100, 130, 24, 2, 128, False),  # not causal, Sq != Skv
    (2, 150, 150, 24, 2, 128, True),   # two requests, distinct positions
    (2, 33, 300, 4, 4, 64, True),      # suffix queries over a longer kv
])
def test_flash_kernel_positions_and_shapes(dev, B, Sq, Skv, H, K, hd,
                                           causal):
    """hd 64, causal=False, and B = 2 with per-request positions (the
    second request's queries shifted back, so some of its KV tiles are
    wholly in the future): the tensor-core kernel against its plain
    version within one bf16 step."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = _randn(g, (B, Sq, H, hd), dev, torch.bfloat16)
    k, v = (_randn(g, (B, Skv, K, hd), dev, torch.bfloat16)
            for _ in range(2))
    qp = torch.arange(Sq, device=dev) + (Skv - Sq)
    qp = torch.stack([qp - 40 * b for b in range(B)]).clamp_min(0)
    kp = torch.arange(Skv, device=dev).expand(B, Skv)
    out = flash_attention(q, k, v, qp, kp, causal=causal, block_k=256)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, qp, kp, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def test_quant_kernels_bit_exact(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = _randn(g, (30 * 48 * 256,), dev) * 3
    for u in (torch.full_like(x, 0.5), torch.rand(x.shape, generator=g,
                                                  device=dev)):
        for mag in (1.0, 1e-4, 1e4):
            q, s = quantize(x * mag, u, block=256)
            rq, rs = quantize_ref(x * mag, u, block=256)
            assert torch.equal(q, rq) and torch.equal(s, rs)
            assert torch.equal(dequantize(q, s, block=256),
                               dequantize_ref(rq, rs, block=256))


# K * hd of every registry configuration, the reduced ones' 32 and 64, and
# a ragged block (a multiple of 4 f32 but not of 8 bf16)
QUANT_BLOCKS = (32, 64, 256, 512, 1024, 1280, 2048, 3072, 36)


def _at_offset(t, offset):
    """A copy of t as a view ``offset`` elements into a larger tensor."""
    v = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = v[offset:]
    v.copy_(t)
    return v


@pytest.mark.parametrize("block", QUANT_BLOCKS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_every_form(dev, block, x_dtype):
    """Both kernels bit-exact against their plain versions: x f32 or bf16,
    u random or one value expanded (stride 0), out f32 or bf16; aligned
    (the vector kernels) and as views at an odd offset (the scalar ones)."""
    g = torch.Generator(device=dev).manual_seed(block)
    nb = 37
    n = nb * block
    x = (_randn(g, (n,), dev) * 3).to(x_dtype)
    for one_u in (False, True):
        u = (torch.full((1,), 0.5, device=dev).expand(n) if one_u
             else torch.rand(n, generator=g, device=dev))
        rq, rs = quantize_ref(x, u, block=block)
        for offset in (0, 1):
            xo = _at_offset(x, offset)
            uo = u if one_u else _at_offset(u, offset)
            before = LAUNCHES["quantize"]
            q, s = quantize(xo, uo, block=block)
            torch.cuda.synchronize()
            assert LAUNCHES["quantize"] == before + 1
            assert torch.equal(q, rq) and torch.equal(s, rs), (one_u, offset)
            for out_dtype in (torch.float32, torch.bfloat16):
                out = dequantize(_at_offset(q, offset), s, block=block,
                                 out_dtype=out_dtype)
                assert out.dtype == out_dtype
                assert torch.equal(out, dequantize_ref(
                    rq, rs, block=block, out_dtype=out_dtype))


def test_quant_kernels_empty_and_refused(dev):
    """n = 0 launches nothing; a strided u that is not one value is
    refused, as is an x of another dtype."""
    before = dict(LAUNCHES)
    q, s = quantize(torch.zeros(0, device=dev), torch.zeros(0, device=dev),
                    block=256)
    assert q.shape == (0,) and s.shape == (0,)
    out = dequantize(q, s, block=256, out_dtype=torch.bfloat16)
    assert out.shape == (0,) and dict(LAUNCHES) == before
    x = torch.ones(512, device=dev)
    with pytest.raises(ValueError, match="not contiguous"):
        quantize(x, torch.rand(1024, device=dev)[::2], block=256)
    with pytest.raises(ValueError, match="f32/bf16"):
        quantize(x.half(), torch.rand(512, device=dev), block=256)


def test_engine_quant_exec_on_card(dev):
    """The engine's int8 round trip on bf16 rows: one quantize and one
    dequantize launch a call (the step is captured, and its warm-up
    launched, when it is built), bf16 out, bit-exact against the plain
    path on the CPU."""
    cfg = get_config("starcoder2-3b").reduced(head_dim=64)
    params = lm.init_params(cfg, 0, device=dev)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          quant="int8", cache_dtype="bf16"),
                        max_seq=64, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    kv = _randn(g, (cfg.n_layers, 32, cfg.n_kv_heads, cfg.hd), dev,
                torch.bfloat16)
    step = eng._quant_exec(32)
    reset_launches()
    out = step(kv)
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == LAUNCHES["dequantize"] == 1
    block = cfg.n_kv_heads * cfg.hd
    flat = kv.cpu().reshape(-1).float()
    rq, rs = quantize_ref(flat, torch.full_like(flat, 0.5), block=block)
    want = dequantize_ref(rq, rs, block=block).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.cpu(), want.reshape(kv.shape))


@pytest.mark.parametrize("B,S,D,N,xdt,h0", [
    (1, 37, 8192, 16, torch.bfloat16, False),    # ragged prefill, bf16 x
    (1, 64, 1000, 8, torch.float32, True),       # ragged D, N = 8
    (8, 1, 8192, 16, torch.bfloat16, True),      # decode tick
    (2, 5, 256, 4, torch.float32, True),         # multi-token decode
])
def test_scan_kernel_matches_plain(dev, B, S, D, N, xdt, h0):
    """The selective-scan kernel against its plain version: y and h_last
    within 1e-4 (f32 rounding of expf and of the <h, C> sum over S steps);
    ``h_out=h0`` writes the state in place."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _randn(g, (B, S, D), dev, xdt)
    dt = (_randn(g, (B, S, D), dev).abs() * 0.1).to(xdt)
    Bm, Cm = (_randn(g, (B, S, N), dev) for _ in range(2))
    A = -_randn(g, (D, N), dev).abs() - 0.1
    h = _randn(g, (B, D, N), dev) if h0 else None
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
    hs = None if h is None else h.clone()
    reset_launches()
    y, hl = selective_scan(x, dt, Bm, Cm, A, hs, h_out=hs)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 1
    assert hs is None or hl is hs
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hl, rh, atol=1e-4, rtol=1e-4)


def _scan_model_inputs(g, B, S, D, N, dev, R=256):
    """The scan's inputs as the model hands them over: x and dt bf16, Bm
    and Cm bf16 views into one (B, S, R + 2N) projection."""
    x = _randn(g, (B, S, D), dev, torch.bfloat16)
    dt = torch.nn.functional.softplus(_randn(g, (B, S, D), dev)).to(
        torch.bfloat16)
    proj = _randn(g, (B, S, R + 2 * N), dev, torch.bfloat16)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        D, N).contiguous()
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("S", [1, 2, 5, 16, 37, 96, 256, 512])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_scan_kernel_strided_bf16_bc(dev, S, N):
    """Bm and Cm read where they lie (bf16 views of the projection), at
    decode-like shapes (B = 8 from a stored state, ``h_out`` aliasing
    ``h0``) and prefill-like ones (B = 1 from zeros); D = 8192 at N = 16,
    a ragged 1000 otherwise: within 1e-4 of the plain version, and equal
    to the kernel on contiguous f32 copies of the same values."""
    g = torch.Generator(device=dev).manual_seed(7)
    B = 8 if S <= 16 else 1
    D = 8192 if N == 16 else 1000
    x, dt, Bm, Cm, A = _scan_model_inputs(g, B, S, D, N, dev)
    h = _randn(g, (B, D, N), dev) if B == 8 else None
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
    hs = None if h is None else h.clone()
    y, hl = selective_scan(x, dt, Bm, Cm, A, hs, h_out=hs)
    torch.cuda.synchronize()
    assert hs is None or hl is hs
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hl, rh, atol=1e-4, rtol=1e-4)
    y2, h2 = selective_scan(x, dt, Bm.float().contiguous(),
                            Cm.float().contiguous(), A, h)
    assert torch.equal(y, y2) and torch.equal(hl, h2)


@pytest.mark.parametrize("S", [5, 21])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_scan_kernel_every_build(dev, N, S):
    """Each build of the kernel, direct (S = 5) and chunked (S = 21, a
    ragged last chunk), for every N, from a stored state at a ragged D; a
    step with dt = 0 passes the state through exactly."""
    g = torch.Generator(device=dev).manual_seed(8)
    B, D, live = 3, 200, S - 2
    assert launch_plan(S, N)[1] == (S > SHORT_S)
    x, dt, Bm, Cm, A = _scan_model_inputs(g, B, S, D, N, dev)
    dt[:, live:] = 0
    h = _randn(g, (B, D, N), dev)
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
    y, hl = selective_scan(x, dt, Bm, Cm, A, h)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hl, rh, atol=1e-4, rtol=1e-4)
    _, h_live = selective_scan(x[:, :live].contiguous(),
                               dt[:, :live].contiguous(), Bm[:, :live],
                               Cm[:, :live], A, h)
    assert torch.equal(hl, h_live)


@pytest.mark.parametrize("S", [3, 40])
def test_scan_kernel_unaligned_inputs(dev, S):
    """A D that is not a multiple of 4 and Bm, Cm at an odd offset and
    stride (a projection of R = 255 columns plus 2N): both kernels read
    bf16 inputs at any alignment; from a stored state, written in place."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, D, N = 2, 203, 16
    x, dt, Bm, Cm, A = _scan_model_inputs(g, B, S, D, N, dev, R=255)
    h = _randn(g, (B, D, N), dev)
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
    y, hl = selective_scan(x, dt, Bm, Cm, A, h, h_out=h)
    torch.cuda.synchronize()
    assert hl is h
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hl, rh, atol=1e-4, rtol=1e-4)


def test_reduced_decode_paged_matches_gather_and_serve(dev):
    cfg = get_config("starcoder2-3b").reduced(head_dim=64)
    params = lm.init_params(cfg, 0, device=dev)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=16,
                   prefix_share=True, quant="int8")
    eng = ServingEngine(params, cfg, setting, max_seq=64, device=dev)
    eng.warm_start(max_prompt=40)
    trace = make_trace("shared_prefix", 400.0, 0.03, vocab=cfg.vocab_size,
                       seed=0, prefix_len=32, tail_lens=(2, 8),
                       max_news=(4, 8))
    reset_launches()
    stats = serve_loop(eng, trace)
    assert stats["completed"] == len(trace)
    dense = ("paged_attention", "flash_attention", "quantize", "dequantize")
    assert all(LAUNCHES[k] > 0 for k in dense), LAUNCHES
    eng.pool.check_invariants()
    cache = eng.pool.decode_cache()
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    pos = torch.tensor([3, 17, 30, 9], dtype=torch.int32, device=dev)
    lg_g, _ = lm.decode_step(params, {k: v.clone() for k, v in cache.items()},
                             tok, pos, cfg, ModelKnobs(attn_impl="gather"))
    lg_p, _ = lm.decode_step(params, {k: v.clone() for k, v in cache.items()},
                             tok, pos, cfg, ModelKnobs(attn_impl="paged"))
    np.testing.assert_allclose(lg_p.float().cpu().numpy(),
                               lg_g.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


def test_reduced_ssm_serve_launches_the_scan(dev):
    """Reduced falcon-mamba served on the card: every request completes and
    the scan kernel ran in prefill and decode; decode from the stored
    state reproduces a full-sequence prefill."""
    cfg = get_config("falcon-mamba-7b").reduced()
    params = lm.init_params(cfg, 0, device=dev)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4), max_seq=64,
                        device=dev)
    eng.warm_start(max_prompt=40)
    trace = make_trace("mixed_lengths", 400.0, 0.03, vocab=cfg.vocab_size,
                       seed=0, short_lens=(2, 8), long_lens=(20, 40),
                       max_news=(4, 8))
    reset_launches()
    stats = serve_loop(eng, trace)
    assert stats["completed"] == len(trace)
    assert LAUNCHES["selective_scan"] > 0
    assert eng.pool.n_active == 0
    tok = torch.randint(0, cfg.vocab_size, (2, 9), device=dev)
    full, _ = lm.prefill(params, tok, cfg)
    shapes = lm.init_cache_shapes(cfg, 2)
    cache = {"conv": torch.zeros(shapes["conv"], device=dev,
                                 dtype=torch.bfloat16),
             "h": torch.zeros(shapes["h"], device=dev)}
    for t in range(9):
        lg, cache = lm.decode_step(params, cache, tok[:, t:t + 1],
                                   torch.full((2,), t, device=dev), cfg)
    np.testing.assert_allclose(lg[:, 0].float().cpu().numpy(),
                               full[:, -1].float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------- graphs
def _graph_engine(dev, family, **setting):
    cfg = (get_config("starcoder2-3b").reduced(head_dim=64)
           if family == "dense" else get_config("falcon-mamba-7b").reduced())
    params = lm.init_params(cfg, 0, device=dev)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4, block_size=16,
                                          **setting), max_seq=64,
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    pool = eng.pool
    if pool.kind == "paged":
        for t in pool.kv.values():
            t.copy_(_randn(g, t.shape, dev, t.dtype))
        pool.tables[:] = (np.arange(4 * pool.mb).reshape(4, pool.mb) + 1)
    else:
        for t in pool.state.values():
            t.copy_(_randn(g, t.shape, dev, t.dtype))
    return cfg, params, eng, g


def _state(eng):
    pool = eng.pool
    tensors = dict(pool.kv) if pool.kind == "paged" else dict(pool.state)
    if getattr(pool, "saved", None) is not None:
        tensors.update({"saved_" + k: v for k, v in pool.saved.items()})
    return tensors


def _flat(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return [out]


def _step_case(eng, cfg, g, dev, case):
    """(entry, its arguments) of one step key of the engine."""
    n = eng.pool.n_slots
    tok = lambda B, S: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device=dev)
    pos = torch.tensor([3, 17, 30, 9], dtype=torch.int32, device=dev)
    if case.startswith("decode"):
        s = int(case[len("decode"):])
        cols = eng._ctx_cols(40)
        return (eng._decode_exec(cols, s),
                (eng.params, eng.pool.decode_cache(), tok(n, s), pos))
    if case == "replay2":
        eng.pool.save_state()
        return (eng._replay_exec(2),
                (eng.params, eng.pool.saved, tok(n, 2), pos))
    if case.startswith("prefill"):
        last = int(case.split("@")[1])
        return (eng._prefill_exec(32),
                (eng.params, tok(1, 32), torch.tensor([last], device=dev)))
    if case == "chunkpf":
        return (eng._chunk_prefill_exec(16),
                (eng.params, {"k": eng.pool.kv["k"], "v": eng.pool.kv["v"]},
                 torch.as_tensor(eng.pool.tables[1:2], device=dev),
                 tok(1, 16),
                 torch.tensor([20], dtype=torch.int32, device=dev),
                 torch.tensor([11], device=dev)))
    assert case == "quant"
    rows = _randn(g, (cfg.n_layers, 32, cfg.n_kv_heads, cfg.hd), dev,
                  torch.bfloat16)
    return eng._quant_exec(32), (rows,)


@pytest.mark.parametrize("family,case", [
    ("dense", "decode1"), ("dense", "decode4"), ("dense", "prefill@0"),
    ("dense", "prefill@21"), ("dense", "chunkpf"), ("dense", "quant"),
    ("ssm", "decode1"), ("ssm", "decode3"), ("ssm", "replay2"),
    ("ssm", "prefill@0"), ("ssm", "prefill@21")])
def test_graph_replay_equals_eager(dev, family, case):
    """Every step key as a captured graph against its eager callable on a
    copy of the same pool: outputs and the pool's tensors bit for bit."""
    cfg, params, eng, g = _graph_engine(dev, family, prefix_share=True,
                                        quant="int8")
    entry, args = _step_case(eng, cfg, g, dev, case)
    assert hasattr(entry, "graph") and entry.eager is not entry
    state = _state(eng)
    before = {k: v.clone() for k, v in state.items()}
    got = [t.clone() for t in _flat(entry(*args))]
    after = {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        v.copy_(before[k])
    want = _flat(entry.eager(*args))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b), case
    for k, v in state.items():
        assert torch.equal(after[k], v), (case, k)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_cold_capture_leaves_live_state_untouched(dev, family):
    """A step captured mid-serve (the verify step at S = 3, here after a
    first decode) runs its eager warm-up on zero tensors, never on the
    live pool: every live tensor is bit for bit what it was."""
    cfg, params, eng, g = _graph_engine(dev, family)
    eng._decode_exec(eng._ctx_cols(40))
    state = _state(eng)
    before = {k: v.clone() for k, v in state.items()}
    eng._decode_exec(eng._ctx_cols(40), 3)
    torch.cuda.synchronize()
    for k, v in state.items():
        assert torch.equal(before[k], v), k


def test_replays_count_the_captured_launches(dev):
    """LAUNCHES rises by the captured counts on every replay: a dense
    decode step launches paged attention once a layer, an ssm step the
    scan once a layer, an int8 round trip each quant kernel once."""
    for family, kernel, make in (
            ("dense", "paged_attention", lambda e: e._decode_exec(0)),
            ("ssm", "selective_scan", lambda e: e._decode_exec(0)),
            ("dense", "quantize", lambda e: e._quant_exec(32))):
        cfg, params, eng, g = _graph_engine(dev, family)
        entry, args = _step_case(eng, cfg, g, dev,
                                 "quant" if kernel == "quantize"
                                 else "decode1")
        want = 1 if kernel == "quantize" else cfg.n_layers
        assert entry.launches[kernel] == want
        reset_launches()
        for _ in range(3):
            entry(*args)
        assert LAUNCHES[kernel] == 3 * want, (kernel, dict(LAUNCHES))


def test_shared_graph_pool_needs_outputs_consumed(dev):
    """Why the engine reads or copies every step's outputs before the next
    replay: steps share one memory pool, and a step captured later may
    place its output where an earlier step keeps an intermediate.  Holding
    that output across a replay of the earlier step loses it; a copy
    taken before keeps it."""
    from repro_torch.core.lru import GraphStep
    pool = torch.cuda.graph_pool_handle()
    n = 1 << 20
    tmp_at = []

    def a(x):
        tmp = x * 2.0                   # freed when the capture ends
        tmp_at.append(tmp.data_ptr())
        return tmp.sum(0, keepdim=True)

    def b(x):
        return x + 1.0

    x = torch.randn(n, device=dev)
    ga = GraphStep(a, x, inputs=(0,), pool=pool)
    gb = GraphStep(b, x, inputs=(0,), pool=pool)
    assert gb.out.data_ptr() == tmp_at[-1]
    out = gb(x)
    kept = out.clone()
    ga(torch.randn(n, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(kept, x + 1.0)
    assert not torch.equal(out, kept)      # overwritten by the replay of a
