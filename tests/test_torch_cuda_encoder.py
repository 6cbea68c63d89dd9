"""PyTorch port on the card, the encoder family (hubert-xlarge): the flash
forward and backward at hd 80, not causal, against their plain versions
(ragged lengths, keys at negative positions masked, the training shape),
then a reduced encoder at hd 80 encoding and training on frames on the
card against the CPU's plain path.  Every test here needs an NVIDIA GPU
and skips without one; ``python3 chip_smoke.py`` runs the same checks at
full width (phase 3's encoder rows and phase 13)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, tree_map
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.optim import make_optimizer
from repro_torch.ps.stepfn import StepKnobs, _grads, build_train_step
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda

HD = 80
BF16_TOL = 2e-2        # one bf16 step at |x| < 4, plus slack
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


def _case(dev, B, S, H, K, start, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = _randn(g, (B, S, H, HD), dev), _randn(g, (B, S, H, HD), dev)
    k, v = _randn(g, (B, S, K, HD), dev), _randn(g, (B, S, K, HD), dev)
    pos = (torch.arange(S, device=dev) + start)[None].expand(B, S)
    return q, k, v, do, pos


@pytest.mark.parametrize("B,S,H,K,causal,start", [
    (4, 1024, 16, 16, False, 0),     # hubert's training shape, G = 1
    (1, 37, 16, 16, False, 0),       # one ragged tile
    (2, 1000, 16, 16, False, 0),     # a ragged last tile
    (1, 300, 8, 2, False, -100),     # keys at negative positions, G = 4
    (2, 200, 16, 16, True, 0),       # causal at hd 80
])
def test_flash_kernel_at_hd80(dev, B, S, H, K, causal, start):
    """The forward at hd 80 (5 k16 steps, 10 n8 tiles of O, a 176-byte
    shared-memory row), not causal at hubert's shape, ragged, with keys at
    negative positions (masked, as the model's chunked attention masks
    them) and causal: within one bf16 step of the plain version, the rows'
    log-sum-exp within LSE_TOL."""
    q, k, v, _, pos = _case(dev, B, S, H, K, start, S + H)
    out, lse = flash_attention(q, k, v, pos, pos, causal=causal,
                               return_lse=True)
    torch.testing.assert_close(
        out.float(), attention_ref(q, k, v, pos, pos,
                                   causal=causal).float(),
        atol=BF16_TOL, rtol=BF16_TOL)
    ref = attention_lse_ref(q, k, pos, pos, causal=causal)
    assert float((lse - ref).abs().max()) <= LSE_TOL * max(
        1.0, float(ref.abs().max()))


@pytest.mark.parametrize("B,S,H,K,causal,start", [
    (4, 1024, 16, 16, False, 0),     # hubert's training shape: P = 1
    (1, 1000, 16, 16, False, 0),     # ragged
    (2, 130, 8, 2, False, -70),      # negative keys (a whole tile), P = 4
    (1, 200, 4, 4, True, 0),         # causal at hd 80
])
def test_flash_backward_at_hd80(dev, B, S, H, K, causal, start):
    """The backward at hd 80 over tiles of 128 columns (the second TMA
    box 16 columns of data and 48 zero-filled; the fifth k16 step of S and
    dP at that box's base): within 2% of the largest |gradient| of
    autograd through the plain version, finite, bit for bit across two
    calls; a key at a negative position gets exactly no dk and dv."""
    q, k, v, do, pos = _case(dev, B, S, H, K, start, S + H)
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
    if start < 0:
        assert not got[1][:, :-start].any() and not got[2][:, :-start].any()


def test_flash_refuses_an_unbuilt_head_dim(dev):
    """No fallback: a head dim outside the builds raises on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn(g, (1, 64, 2, 72), dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention(q, q, q, causal=False)


def _encoder(dev, seed=0):
    cfg = get_config("hubert-xlarge").reduced(head_dim=HD, n_kv_heads=4)
    return cfg, lm.init_params(cfg, seed, device=dev)


def test_reduced_encoder_encodes_on_the_card(dev):
    """The encode over frames (flash forward at hd 80, not causal, once a
    layer) against the same encode on the CPU (plain versions): every
    frame's logits within LOGIT_TOL; the serving engine refuses the model
    on the card as on the CPU."""
    cfg, params = _encoder(dev)
    batch = synthetic_batch(cfg, ShapeConfig("p", 150, 2, "prefill"),
                            seed=3, device=dev)
    reset_launches()
    hidden, _ = lm.forward(params, None, cfg, frontend=batch["frontend"])
    lg = lm.logits_fn(params, hidden, cfg)
    assert LAUNCHES["flash_attention"] == cfg.n_layers
    cpu = tree_map(lambda t: t.cpu(), params)
    hidden_c, _ = lm.forward(cpu, None, cfg,
                             frontend=batch["frontend"].cpu())
    lg_c = lm.logits_fn(cpu, hidden_c, cfg)
    assert lg.shape == (2, 150, cfg.vocab_size)
    np.testing.assert_allclose(lg.float().cpu().numpy(),
                               lg_c.float().numpy(), atol=LOGIT_TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="no decode step"):
        ServingEngine(params, cfg, max_seq=64, device=dev)


def test_reduced_encoder_trains_on_the_card(dev):
    """One training step's loss and gradients over frames (flash forward
    with lse and backward at hd 80, one launch each a layer) against the
    CPU's plain path on the same parameters and batch: the loss within
    1e-2, every leaf within 5% of its largest |value|, ``embed/tokens``
    exactly zero and ``frontend/proj`` not."""
    cfg, params = _encoder(dev)
    batch = synthetic_batch(cfg, ShapeConfig("t", 130, 2, "train"), seed=4,
                            device=dev)
    reset_launches()
    loss, _, grads = _grads(params, batch, cfg, ModelKnobs())
    assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_bwd"] \
        == cfg.n_layers
    cpu = tree_map(lambda t: t.cpu(), params)
    loss_c, _, grads_c = _grads(cpu, {k: v.cpu() for k, v in batch.items()},
                                cfg, ModelKnobs())
    assert abs(float(loss) - float(loss_c)) <= 1e-2
    for (name, a), b in zip(zip(*flatten(grads)), flatten(grads_c)[1]):
        a, b = a.float().cpu(), b.float()
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max()), \
            name
    assert not grads["embed"]["tokens"].any()
    assert float(grads["frontend"]["proj"].abs().max()) > 0


def test_reduced_encoder_train_steps_lower_the_loss(dev):
    """``build_train_step`` with Adam and ``remat="full"`` on one repeated
    frame batch: the flash forward runs twice a layer a step (once more in
    the recomputation), the backward once, and the loss falls over 8
    steps."""
    cfg, params = _encoder(dev)
    state = {"params": params, "opt": make_optimizer(TrainConfig())[0](
        params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
    batch = synthetic_batch(cfg, ShapeConfig("t", 128, 4, "train"), seed=5,
                            device=dev)
    step = build_train_step(cfg, TrainConfig(learning_rate=3e-3),
                            StepKnobs(remat="full"))
    reset_launches()
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert LAUNCHES["flash_attention"] == 2 * 8 * cfg.n_layers
    assert LAUNCHES["flash_attention_bwd"] == 8 * cfg.n_layers
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
