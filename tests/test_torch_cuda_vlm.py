"""PyTorch port on the card, the vlm family (phi-3-vision-4.2b): the three
attention kernels at hd 96 against their plain versions — paged attention
(D = 3 dims a lane) over bf16 and f32 pools, the flash forward with and
without the log-sum-exp, the flash backward over tiles padded to 128
columns — then a reduced vlm at hd 96 served (prefix sharing, int8 KV,
speculation) and trained with image patches on the card.  Every test here
needs an NVIDIA GPU and skips without one; ``python3 chip_smoke.py`` runs
the same checks at full width (phase 3's vlm rows and phase 12)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, tree_map
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.ps.stepfn import _grads
from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                 serve_loop)
from repro_torch.serving.workload import make_trace

pytestmark = pytest.mark.cuda

HD = 96
BF16_TOL = 2e-2        # one bf16 step at |x| < 4, plus slack
F32_TOL = 2e-5         # an f32 query over an f32 pool: summation order
LSE_TOL = 1e-4         # f32 exp2/log2 against logsumexp, relative
LOGIT_TOL = 4 / 64     # the reduced model's logits (|logit| < 4) by two
                       # paths that round bf16 products apart: four steps
BWD_RTOL = 2e-2        # the backward against autograd through the plain
                       # version, relative to the largest |gradient|


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


@pytest.mark.parametrize("H,K", [(32, 32), (8, 2)])
@pytest.mark.parametrize("S,bs,pool_dt,q_dt", [
    (1, 16, torch.bfloat16, torch.bfloat16),
    (4, 16, torch.bfloat16, torch.bfloat16),
    (1, 8, torch.float32, torch.bfloat16),
    (4, 8, torch.float32, torch.float32),
    (64, 16, torch.bfloat16, torch.bfloat16),
])
def test_paged_kernel_at_hd96(dev, H, K, S, bs, pool_dt, q_dt):
    """Decode, verify and a suffix prefill at hd 96, MHA (phi-3-vision's
    32 / 32) and G = 4, both block sizes, bf16 and f32 pools and queries,
    contexts up to 1,000 (many KV splits), each case twice (the split
    counters return to zero)."""
    g = torch.Generator(device=dev).manual_seed(H + S + bs)
    B = 1 if S == 64 else 8
    mb = 1024 // bs
    nb = B * mb + 1
    kp, vp = _randn(g, (nb, bs, K, HD), dev, pool_dt), _randn(
        g, (nb, bs, K, HD), dev, pool_dt)
    bt = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
          .reshape(B, mb) + 1).to(torch.int32)
    pos = torch.tensor([256] if B == 1 else
                       [0, 15, 16, 300, 511, 640, 900, 1000 - S],
                       dtype=torch.int32, device=dev)
    q = _randn(g, (B, S, H, HD), dev, q_dt)
    tol = F32_TOL if q_dt == pool_dt == torch.float32 else BF16_TOL
    reset_launches()
    for _ in range(2):
        out = paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), paged_attention_ref(q, kp, vp, bt, pos).float(),
            atol=tol, rtol=tol)
    assert LAUNCHES["paged_attention"] == 2


@pytest.mark.parametrize("B,S,H,K,causal", [(1, 37, 32, 32, True),
                                            (1, 320, 32, 32, True),
                                            (2, 200, 8, 2, True),
                                            (1, 130, 32, 32, False)])
def test_flash_kernel_at_hd96(dev, B, S, H, K, causal):
    """The forward at hd 96 (6 k16 steps, a 208-byte shared-memory row),
    ragged lengths, GQA and not causal; with the rows' log-sum-exp too."""
    g = torch.Generator(device=dev).manual_seed(S + H)
    q = _randn(g, (B, S, H, HD), dev)
    k, v = _randn(g, (B, S, K, HD), dev), _randn(g, (B, S, K, HD), dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, causal=causal,
                               return_lse=True)
    torch.testing.assert_close(
        out.float(), attention_ref(q, k, v, pos, pos,
                                   causal=causal).float(),
        atol=BF16_TOL, rtol=BF16_TOL)
    ref = attention_lse_ref(q, k, pos, pos, causal=causal)
    assert float((lse - ref).abs().max()) <= LSE_TOL * max(
        1.0, float(ref.abs().max()))


@pytest.mark.parametrize("B,S,H,K,causal", [(4, 512, 32, 32, True),
                                            (2, 190, 8, 4, True),
                                            (1, 130, 12, 2, True),
                                            (2, 100, 32, 32, False)])
def test_flash_backward_at_hd96(dev, B, S, H, K, causal):
    """The backward at hd 96 over tiles of 128 columns (the second TMA box
    half zero-filled): phi-3-vision's training shape (G = 1, one CTA a
    cluster), G = 2 and G = 6 (clusters of 2 and 3), ragged and not
    causal.  Within 2% of the largest |gradient| of autograd through the
    plain version, finite, and bit for bit across two calls (a store past
    a row's 96 columns would land on the next head's row)."""
    g = torch.Generator(device=dev).manual_seed(S + H)
    q, do = _randn(g, (B, S, H, HD), dev), _randn(g, (B, S, H, HD), dev)
    k, v = _randn(g, (B, S, K, HD), dev), _randn(g, (B, S, K, HD), dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, causal=causal,
                               return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                              causal=causal)
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, attention_bwd_ref(q, k, v, do, pos, pos,
                                           causal=causal)):
        assert torch.isfinite(a.float()).all()
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_RTOL * float(b.float().abs().max())


def _vlm(dev, seed=0):
    cfg = get_config("phi-3-vision-4.2b").reduced(head_dim=HD,
                                                  n_kv_heads=4)
    return cfg, lm.init_params(cfg, seed, device=dev)


@pytest.mark.parametrize("setting", [
    {"quant": "int8"}, {"spec_k": 3.0, "drafter": "ngram"}])
def test_reduced_vlm_serve_launches_every_kernel(dev, setting):
    """The reduced vlm at hd 96 (4 q / 4 kv heads) served from tokens with
    prefix sharing, int8 KV or speculation: every request completes, flash
    and paged attention (and the int8 kernels) ran, the pool leaks
    nothing, and (bf16 KV) each served token is within LOGIT_TOL of the
    argmax of a full-sequence prefill (tie-aware; int8 KV is another
    computation)."""
    cfg, params = _vlm(dev)
    eng = ServingEngine(params, cfg, dict(
        DEFAULT_SERVING_SETTING, max_batch=4, block_size=16,
        prefix_share=True, cache_dtype="bf16", **setting), max_seq=64,
        device=dev)
    eng.warm_start(max_prompt=48)
    trace = make_trace("shared_prefix", 400.0, 0.03, vocab=cfg.vocab_size,
                       seed=0, prefix_len=32, tail_lens=(2, 12),
                       max_news=(4, 8))
    reset_launches()
    stats = serve_loop(eng, trace)
    assert stats["completed"] == len(trace)
    want = ["paged_attention", "flash_attention"]
    if setting.get("quant") == "int8":
        want += ["quantize", "dequantize"]
    for k in want:
        assert LAUNCHES[k] > 0, dict(LAUNCHES)
    eng.pool.check_invariants()
    assert eng.pool.n_active == 0
    for r in eng.finished if "quant" not in setting else ():
        seq = torch.tensor([list(r.prompt) + r.tokens_out[:-1]], device=dev)
        hidden, _ = lm.forward(params, seq, cfg)
        lg = lm.logits_fn(params, hidden[:, len(r.prompt) - 1:], cfg)[0]
        got = torch.tensor(r.tokens_out, device=dev)
        gap = lg.float().max(-1).values - lg.float().gather(
            1, got[:, None])[:, 0]
        assert float(gap.max()) <= LOGIT_TOL, (r.rid, gap)


def test_reduced_vlm_prefill_with_patches_on_the_card(dev):
    """A prefill of patches + tokens through the flash kernel against the
    same prefill on the CPU (plain versions): logits and the KV within
    LOGIT_TOL."""
    cfg, params = _vlm(dev)
    batch = synthetic_batch(cfg, ShapeConfig("p", cfg.frontend_len + 29, 2,
                                             "prefill"), seed=3, device=dev)
    lg, cache = lm.prefill(params, batch["tokens"], cfg,
                           frontend=batch["frontend"])
    cpu = tree_map(lambda t: t.cpu(), params)
    lg_c, cache_c = lm.prefill(cpu, batch["tokens"].cpu(), cfg,
                               frontend=batch["frontend"].cpu())
    assert cache["k"].shape[2] == cfg.frontend_len + 29
    np.testing.assert_allclose(lg.float().cpu().numpy(),
                               lg_c.float().numpy(), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(cache["v"].float().cpu().numpy(),
                               cache_c["v"].float().numpy(),
                               atol=LOGIT_TOL, rtol=0)


def test_reduced_vlm_trains_with_patches_on_the_card(dev):
    """One training step's loss and gradients with patches (flash forward
    with lse and backward at hd 96, one launch each a layer) against the
    CPU's plain path on the same parameters and batch: the loss within
    1e-2, every leaf (``frontend/proj`` included) within 5% of its largest
    |value|."""
    cfg, params = _vlm(dev)
    batch = synthetic_batch(cfg, ShapeConfig("t", cfg.frontend_len + 60, 2,
                                             "train"), seed=4, device=dev)
    reset_launches()
    loss, _, grads = _grads(params, batch, cfg, ModelKnobs())
    assert LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    cpu = tree_map(lambda t: t.cpu(), params)
    loss_c, _, grads_c = _grads(cpu, {k: v.cpu() for k, v in batch.items()},
                                cfg, ModelKnobs())
    assert abs(float(loss) - float(loss_c)) <= 1e-2
    for (name, a), b in zip(zip(*flatten(grads)), flatten(grads_c)[1]):
        a, b = a.float().cpu(), b.float()
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max()), \
            name
    assert float(grads["frontend"]["proj"].abs().max()) > 0
