"""PyTorch port on the card, the moe family: the paged and flash kernels at
the moe configurations' head groups (llama4-scout's 40 q / 8 kv heads,
G = 5, and qwen3-moe's 64 / 4, G = 16, hd 128), the flash backward where a
cluster splits a kv head's 5 query heads over one CTA (P = 1), a reduced
moe serve at hd 128 that launches every attention kernel and the int8
ones, and a captured moe decode step equal to its eager step.  Every test
here needs an NVIDIA GPU and skips without one; ``python3 chip_smoke.py``
runs the same checks at full width (phase 3's moe rows and phase 11)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                 serve_loop)
from repro_torch.serving.workload import make_trace

from test_torch_cuda import _flat, _state

pytestmark = pytest.mark.cuda

BF16_TOL = 2e-2        # one bf16 step at |x| < 4, plus slack
BWD_RTOL = 2e-2        # the backward against autograd through the plain
                       # version, relative to the largest |gradient|
GROUPS = [(40, 8), (64, 4)]        # (H, K): llama4-scout, qwen3-moe


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, shape, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("H,K", GROUPS)
@pytest.mark.parametrize("S,pool_dt", [(1, torch.bfloat16),
                                       (4, torch.bfloat16),
                                       (1, torch.float32),
                                       (64, torch.bfloat16)])
def test_paged_kernel_at_the_moe_groups(dev, H, K, S, pool_dt):
    """Decode, verify and a suffix prefill at G = 5 and G = 16 over blocks
    of 16, contexts up to 1,000 (many KV splits), each case twice (the
    split counters return to zero)."""
    g = torch.Generator(device=dev).manual_seed(H + S)
    B = 1 if S == 64 else 8
    mb, hd = 64, 128
    nb = B * mb + 1
    kp, vp = _randn(g, (nb, 16, K, hd), dev, pool_dt), _randn(
        g, (nb, 16, K, hd), dev, pool_dt)
    bt = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
          .reshape(B, mb) + 1).to(torch.int32)
    pos = torch.tensor([256] if B == 1 else
                       [0, 15, 16, 300, 511, 640, 900, 1000 - S],
                       dtype=torch.int32, device=dev)
    q = _randn(g, (B, S, H, hd), dev)
    reset_launches()
    for _ in range(2):
        out = paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), paged_attention_ref(q, kp, vp, bt, pos).float(),
            atol=BF16_TOL, rtol=BF16_TOL)
    assert LAUNCHES["paged_attention"] == 2


@pytest.mark.parametrize("H,K", GROUPS)
@pytest.mark.parametrize("B,S", [(1, 37), (1, 320), (2, 200)])
def test_flash_kernel_at_the_moe_groups(dev, H, K, B, S):
    g = torch.Generator(device=dev).manual_seed(H + S)
    q = _randn(g, (B, S, H, 128), dev)
    k, v = _randn(g, (B, S, K, 128), dev), _randn(g, (B, S, K, 128), dev)
    out = flash_attention(q, k, v, block_k=128)
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v).float(),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("H,K,S", [(40, 8, 512), (40, 8, 190),
                                   (64, 4, 256)])
def test_flash_backward_one_cta_a_cluster(dev, H, K, S):
    """G = 5: the largest divisor of 5 up to 4 is 1, so each CTA of the
    dk/dv pass holds all of a kv head's 5 query heads (P = 1, no partials
    to add); G = 16 splits them over 4.  Within 2% of the largest
    |gradient| of autograd through the plain version, bit for bit across
    two calls."""
    g = torch.Generator(device=dev).manual_seed(S)
    B = 2
    q, do = _randn(g, (B, S, H, 128), dev), _randn(g, (B, S, H, 128), dev)
    k, v = _randn(g, (B, S, K, 128), dev), _randn(g, (B, S, K, 128), dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, attention_bwd_ref(q, k, v, do, pos, pos)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_RTOL * float(b.float().abs().max())


def _moe(dev, arch="llama4-scout-17b-a16e", **kw):
    cfg = get_config(arch).reduced(head_dim=128, **kw)
    return cfg, lm.init_params(cfg, 0, device=dev)


def test_reduced_moe_serve_launches_every_kernel(dev):
    """Reduced llama4-scout at hd 128 (4 experts, capacity factor 1.25, so
    long prefills drop pairs) served with prefix sharing and int8 KV:
    every request completes, flash, paged attention, quantize and
    dequantize all ran, the pool leaks nothing, and the paged decode
    agrees with the gather path on the served pool."""
    cfg, params = _moe(dev, capacity_factor=1.25)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=16,
                   prefix_share=True, quant="int8")
    eng = ServingEngine(params, cfg, setting, max_seq=64, device=dev)
    eng.warm_start(max_prompt=48)
    trace = make_trace("shared_prefix", 400.0, 0.03, vocab=cfg.vocab_size,
                       seed=0, prefix_len=32, tail_lens=(2, 12),
                       max_news=(4, 8))
    reset_launches()
    stats = serve_loop(eng, trace)
    assert stats["completed"] == len(trace)
    for k in ("paged_attention", "flash_attention", "quantize",
              "dequantize"):
        assert LAUNCHES[k] > 0, dict(LAUNCHES)
    eng.pool.check_invariants()
    cache = eng.pool.decode_cache()
    tok = torch.ones((4, 1), dtype=torch.long, device=dev)
    pos = torch.tensor([3, 17, 30, 9], dtype=torch.int32, device=dev)
    lg_g, _ = lm.decode_step(params, {k: v.clone() for k, v in cache.items()},
                             tok, pos, cfg, ModelKnobs(attn_impl="gather"))
    lg_p, _ = lm.decode_step(params, {k: v.clone() for k, v in cache.items()},
                             tok, pos, cfg, ModelKnobs(attn_impl="paged"))
    np.testing.assert_allclose(lg_p.float().cpu().numpy(),
                               lg_g.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("arch,S", [("llama4-scout-17b-a16e", 1),
                                    ("qwen3-moe-235b-a22b", 1),
                                    ("qwen3-moe-235b-a22b", 4)])
def test_moe_decode_graph_replay_equals_eager(dev, arch, S):
    """The moe decode (and verify) step as a captured graph against its
    eager callable on a copy of the same random pool: logits and the pool
    bit for bit (nothing in the moe block reads back to the host, or the
    capture would fail)."""
    cfg, params = _moe(dev, arch)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4, block_size=16),
                        max_seq=64, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for t in eng.pool.kv.values():
        t.copy_(_randn(g, t.shape, dev, t.dtype))
    eng.pool.tables[:] = (np.arange(4 * eng.pool.mb).reshape(4, eng.pool.mb)
                          + 1)
    entry = eng._decode_exec(eng._ctx_cols(40), S)
    assert hasattr(entry, "graph") and entry.eager is not entry
    args = (eng.params, eng.pool.decode_cache(),
            torch.randint(0, cfg.vocab_size, (4, S), generator=g,
                          device=dev),
            torch.tensor([3, 17, 30, 9], dtype=torch.int32, device=dev))
    state = _state(eng)
    before = {k: v.clone() for k, v in state.items()}
    got = [t.clone() for t in _flat(entry(*args))]
    after = {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        v.copy_(before[k])
    want = _flat(entry.eager(*args))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for k, v in state.items():
        assert torch.equal(after[k], v), k
