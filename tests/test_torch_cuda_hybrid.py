"""PyTorch port on the card, the hybrid family (zamba2): the selective scan
at N = 64 with a head's dt and A repeated over its channels, the flash
kernel at hd 64 with one query head a kv head (G = 1), the paged-attention
kernel over the shared block's slab viewed as blocks, and a reduced hybrid
serve whose captured steps replay as their eager steps.  Every test here
needs an NVIDIA GPU and skips without one; ``python3 chip_smoke.py`` runs
the same checks at full width (phase 10)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.kernels.mamba_scan.kernel import launch_plan
from repro_torch.models import lm
from repro_torch.models.attention import (decode_attention, identity_tables,
                                          slab_decode_attention)
from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
from repro_torch.serving import serve_loop
from repro_torch.serving.workload import make_trace

from test_torch_cuda import _flat, _state, _step_case

pytestmark = pytest.mark.cuda

# f32 rounding of the exponential (ex2.approx against exp), the state
# update and the <h, C> sum over <= 512 steps: the scan's bound everywhere
SCAN_TOL = 1e-4
BF16_TOL = 2e-2        # one bf16 step at |x| < 4, plus slack
# Logits of the reduced hybrid on the card, decode from the stored state
# and slab against one prefill: two paths that differ only in rounding.
# scripts/hybrid_decode_gap_card.py measured the largest |difference| over
# 8 seeds (the test's model and tokens are its seed 0) on an H100 80GB
# HBM3 at 700 W: 0.0391, 0.0313, 0.0239, 0.0693, 0.0469, 0.0469, 0.0527,
# 0.0332; the bound is 1.5 x the largest.
DECODE_GAP_TOL = 1.5 * 0.069336


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mamba2_scan_inputs(g, B, S, nh, P, N, dev):
    """The scan's inputs as ``mamba2_block`` hands them over: x f32, dt
    (B, S, nh) repeated over each head's P channels, Bm and Cm f32 views
    of one (B, S, 2N) projection, A a head's scalar over (P, N)."""
    D = nh * P
    x = torch.randn((B, S, D), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=dev))
    dt = dt[..., None].expand(B, S, nh, P).reshape(B, S, D)
    Bm, Cm = torch.randn((B, S, 2 * N), generator=g,
                         device=dev).split(N, dim=-1)
    A = -torch.rand((nh,), generator=g, device=dev) * 2 - 0.05
    A = A[:, None, None].expand(nh, P, N).reshape(D, N)
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("B,S,h0", [
    (8, 1, True), (8, 3, True),                  # decode and verify
    (1, 1, False), (1, 16, False), (1, 37, True), (1, 512, False),
    (2, 9, True)])
def test_scan_kernel_n64(dev, B, S, h0):
    """N = 64 (zamba2's state), both kernels, at D = 64 x 64: within
    SCAN_TOL of the plain version; from h0 the state is written in place."""
    g = torch.Generator(device=dev).manual_seed(11)
    nh, P, N = 64, 64, 64
    x, dt, Bm, Cm, A = _mamba2_scan_inputs(g, B, S, nh, P, N, dev)
    h = (torch.randn((B, nh * P, N), generator=g, device=dev) if h0
         else None)
    ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
    reset_launches()
    y, hl = selective_scan(x, dt, Bm, Cm, A, h, h_out=h)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 1
    assert launch_plan(S, N)[0] == 8
    assert h is None or hl is h
    torch.testing.assert_close(y, ry, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(hl, rh, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("S,kc", [(320, 128), (512, 256), (37, 128)])
def test_flash_kernel_hd64_one_head_a_group(dev, S, kc):
    """The shared block's prefill: H = K = 32, hd 64 (G = 1)."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn((1, S, 32, 64), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, block_k=kc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), attention_ref(q, k, v).float(),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("S,dtype", [(1, torch.bfloat16), (3, torch.bfloat16),
                                     (1, torch.float32), (3, torch.float32)])
def test_slab_decode_kernel(dev, S, dtype):
    """The paged-attention kernel over the slab (8, 1024, 32, 64) viewed
    as blocks of 16 through the identity tables, G = 1, against the dense
    ``decode_attention``; positions at 0, mid-context and where the last
    query sits at max_seq - 1."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, T, K, hd = 8, 1024, 32, 64
    q = torch.randn((B, S, K, hd), generator=g, device=dev).to(
        torch.bfloat16)
    ks, vs = (torch.randn((B, T, K, hd), generator=g, device=dev).to(dtype)
              for _ in range(2))
    pos = torch.tensor([0, 5, 100, 333, 512, 700, T - S - 1, T - S],
                       dtype=torch.int32, device=dev)
    tables = identity_tables(B, T, dev)
    reset_launches()
    out = slab_decode_attention(q, ks, vs, tables, pos=pos)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_attention"] == 1
    ref = decode_attention(q, ks, vs, pos=pos)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)


def _hybrid(dev):
    cfg = get_config("zamba2-1.2b").reduced(head_dim=64, n_layers=3)
    return cfg, lm.init_params(cfg, 0, device=dev)


def test_reduced_hybrid_serve_launches_every_kernel(dev):
    """Reduced zamba2 (3 layers, 2 shared-block applications) served on
    the card: every request completes, the scan, flash and paged kernels
    all ran, and decode from the stored state and slab reproduces a
    full-sequence prefill."""
    cfg, params = _hybrid(dev)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4, cache_dtype="bf16"),
                        max_seq=64, device=dev)
    eng.warm_start(max_prompt=40)
    trace = make_trace("mixed_lengths", 400.0, 0.03, vocab=cfg.vocab_size,
                       seed=0, short_lens=(2, 8), long_lens=(20, 40),
                       max_news=(4, 8))
    reset_launches()
    stats = serve_loop(eng, trace)
    assert stats["completed"] == len(trace) and eng.pool.n_active == 0
    for k in ("selective_scan", "flash_attention", "paged_attention"):
        assert LAUNCHES[k] > 0, dict(LAUNCHES)
    g = torch.Generator(device=dev).manual_seed(14)
    tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=g, device=dev)
    full, _ = lm.prefill(params, tok, cfg)
    cache = {k: torch.zeros(s, device=dev, dtype=torch.float32
                            if k == "h" else torch.bfloat16)
             for k, s in lm.init_cache_shapes(cfg, 2, 16).items()}
    for t in range(9):
        lg, cache = lm.decode_step(params, cache, tok[:, t:t + 1],
                                   torch.full((2,), t, device=dev), cfg)
    # decode (S = 1 products, paged attention over the slab) and prefill
    # (S = 9 products, flash) round in other places (DECODE_GAP_TOL)
    np.testing.assert_allclose(lg[:, 0].float().cpu().numpy(),
                               full[:, -1].float().cpu().numpy(),
                               atol=DECODE_GAP_TOL, rtol=0)


@pytest.mark.parametrize("case", ["decode1", "decode3", "replay2",
                                  "prefill@0", "prefill@21"])
def test_hybrid_graph_replay_equals_eager(dev, case):
    """Every hybrid step key as a captured graph against its eager callable
    on a copy of the same pool (conv, h and the slab filled at random):
    outputs and the pool's tensors bit for bit."""
    cfg, params = _hybrid(dev)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4, cache_dtype="bf16"),
                        max_seq=64, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for t in eng.pool.state.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
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
