"""PyTorch port on the card: each CUDA kernel against its plain version,
the paged decode step against the gather path, and a short serve through
the kernels.  Every test here needs an NVIDIA GPU and skips without one;
``python3 chip_smoke.py`` runs the same checks at full width."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
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


@pytest.mark.parametrize("S,kc", [(128, 128), (200, 256), (37, 128)])
def test_flash_kernel_matches_plain(dev, S, kc):
    g = torch.Generator(device=dev).manual_seed(1)
    q = _randn(g, (1, S, 24, 128), dev, torch.bfloat16)
    k, v = (_randn(g, (1, S, 2, 128), dev, torch.bfloat16) for _ in range(2))
    out = flash_attention(q, k, v, block_k=kc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_quant_kernels_bit_exact(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = _randn(g, (30 * 48 * 256,), dev) * 3
    for u in (torch.full_like(x, 0.5), torch.rand(x.shape, generator=g,
                                                  device=dev)):
        q, s = quantize(x, u, block=256)
        rq, rs = quantize_ref(x, u, block=256)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert torch.equal(dequantize(q, s, block=256),
                           dequantize_ref(rq, rs, block=256))


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
    assert all(LAUNCHES[k] > 0 for k in LAUNCHES), LAUNCHES
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
