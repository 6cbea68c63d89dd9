"""PyTorch port on the card: the training path's kernels against their
plain versions — the flash forward's log-sum-exp, the flash backward, the
int8 kernels at one block per tensor (the grid-wide path) — and one train
step through the kernels against the plain path on the CPU.  Every test
here needs an NVIDIA GPU and skips without one; ``python3 chip_smoke.py``
runs the same checks at full width."""
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, tree_map
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.quant import (dequantize, dequantize_ref, quantize,
                                       quantize_ref)
from repro_torch.ps.compression import compress_grads
from repro_torch.ps.lm_job import LMJob
from repro_torch.ps.stepfn import StepKnobs, build_train_step

pytestmark = pytest.mark.cuda

# A gradient of the flash backward against autograd through the plain
# version, relative to the gradient's largest |value|: the kernel rounds P
# (for dV) and dS (for dQ, dK) to bf16 for its tensor-core products where
# the plain version keeps f32, and both round the result to bf16.
BWD_RTOL = 2e-2
LSE_TOL = 1e-4       # f32 rounding of exp2 / log2 against logsumexp


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, B, Sq, Skv, H, K, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    return r(B, Sq, H, hd), r(B, Skv, K, hd), r(B, Skv, K, hd), r(B, Sq, H,
                                                                  hd)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("B,S,H,K,hd,causal", [
    (2, 128, 2, 2, 64, True),        # G = 1
    (1, 200, 4, 2, 64, True),        # G = 2, ragged
    (2, 320, 24, 2, 128, True),      # G = 12, the model's geometry
    (1, 77, 24, 2, 128, False),      # not causal, ragged
    (1, 64, 8, 4, 64, False),
    (4, 512, 24, 2, 128, True),      # the training shape
    (1, 190, 6, 2, 128, True),       # G = 3: a cluster of 3, ragged
])
def test_flash_backward_matches_plain(dev, B, S, H, K, hd, causal):
    q, k, v, do = _attn_inputs(dev, B, S, S, H, K, hd)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, causal=causal,
                               return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, pos, pos,
                                            causal=causal))
    lse_ref = attention_lse_ref(q, k, pos, pos, causal=causal)
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL * float(
        lse_ref.abs().max().clamp_min(1.0))
    reset_launches()
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == 1
    want = attention_bwd_ref(q, k, v, do, pos, pos, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, b) <= BWD_RTOL, (name, _rel_err(a, b))
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                causal=causal)
    for a, b in zip(got, again):          # no atomics: deterministic
        assert torch.equal(a, b)


def test_flash_backward_at_shifted_positions(dev):
    """Two requests whose queries sit at other positions than their keys:
    the tiles that no row sees are skipped, the masked keys give 0."""
    B, Sq, Skv, H, K, hd = 2, 96, 300, 8, 2, 64
    q, k, v, do = _attn_inputs(dev, B, Sq, Skv, H, K, hd, seed=3)
    qp = torch.stack([torch.arange(Sq, device=dev) + Skv - Sq,
                      torch.arange(Sq, device=dev) + 40])
    kp = torch.arange(Skv, device=dev)[None].expand(B, Skv)
    out, lse = flash_attention(q, k, v, qp, kp, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, qp, kp)
    want = attention_bwd_ref(q, k, v, do, qp, kp)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= BWD_RTOL
    # keys past every query's position get no gradient at all
    assert not got[1][1, Sq + 40:].any() and not got[2][1, Sq + 40:].any()


def test_flash_function_under_checkpoint(dev):
    """The differentiable op recomputes under torch.utils.checkpoint and
    gives the same gradients."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.attention import chunked_attention
    q, k, v, do = _attn_inputs(dev, 1, 128, 128, 8, 2, 64, seed=5)
    pos = torch.arange(128, device=dev)[None]

    def f(q, k, v):
        return chunked_attention(q, k, v, causal=True, q_positions=pos,
                                 kv_positions=pos)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(f(*leaves), leaves, do)
    reset_launches()
    out = checkpoint(f, *leaves, use_reentrant=False)
    ck = torch.autograd.grad(out, leaves, do)
    assert LAUNCHES["flash_attention"] == 2         # forward and recompute
    assert LAUNCHES["flash_attention_bwd"] == 1
    for a, b in zip(plain, ck):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,x_dtype,offset", [
    (3 * 4096 + 8, torch.float32, 0),
    (1 << 20, torch.bfloat16, 0),
    (5_000_011, torch.float32, 0),          # odd: one value a thread
    (1_000_000, torch.bfloat16, 1),         # misaligned view
])
def test_quant_one_block_per_tensor(dev, n, x_dtype, offset):
    g = torch.Generator(device=dev).manual_seed(n % 97)
    x = (torch.randn(n + offset, generator=g, device=dev) * 3)[offset:]
    x = x.to(x_dtype)
    u = torch.rand(n, generator=g, device=dev)
    rq, rs = quantize_ref(x, u, block=n)
    q, s = quantize(x, u, block=n)
    assert s.shape == (1,) and torch.equal(s, rs)
    assert torch.equal(q, rq)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(dequantize(q, s, block=n, out_dtype=out),
                           dequantize_ref(rq, rs, block=n, out_dtype=out))


def test_quant_refuses_n_past_the_int_interface(dev):
    x = torch.zeros(1, device=dev).expand(2 ** 31)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        quantize(x, x, block=2 ** 31)


def test_compress_grads_int8_on_card(dev):
    """Every leaf one block: one quantize and one dequantize launch a leaf,
    values within one int8 step (the leaf's scale) of the original, plus
    the rounding of the result to the leaf's dtype (bf16: 2^-8 of it)."""
    g = torch.Generator(device=dev).manual_seed(2)
    grads = {"a": torch.randn(70_000, generator=g, device=dev).to(
        torch.bfloat16), "b": {"c": torch.randn(33, 129, generator=g,
                                                device=dev)}}
    orig = tree_map(torch.clone, grads)
    reset_launches()
    compress_grads(grads, "int8", 7)
    assert LAUNCHES["quantize"] == LAUNCHES["dequantize"] == 2
    for a, b in zip(flatten(orig)[1], flatten(grads)[1]):
        step = float(a.float().abs().max()) / 127
        ulp = 2.0 ** -8 if a.dtype == torch.bfloat16 else 0.0
        assert bool(((a.float() - b.float()).abs()
                     <= step * 1.0001 + ulp * b.float().abs()).all())


def test_train_step_kernel_path_matches_plain_path(dev):
    """A small config with hd 64 (a kernel head size): one step on the
    card (flash forward and backward, int8 push) against the same step on
    the CPU (plain versions) from the same state and batch."""
    cfg = get_config("starcoder2-3b").reduced(
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=512, n_layers=2)
    knobs = StepKnobs(compression="bf16")
    cards = LMJob(cfg, batch=2, seq=128, device=dev)
    cpus = LMJob(cfg, batch=2, seq=128, device="cpu")
    st = cards.init_state({}, seed=0)
    sc = tree_map(lambda t: t.cpu(), st)
    batch = next(cards.batches(0))
    bc = {k: v.cpu() for k, v in batch.items()}
    reset_launches()
    st, m = build_train_step(cfg, cards.tc, knobs)(st, batch)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_bwd"] \
        == cfg.n_layers
    sc, mc = build_train_step(cfg, cpus.tc, knobs)(sc, bc)
    assert abs(float(m["loss"]) - float(mc["loss"])) <= 1e-2
    for name in ("m", "v"):
        for a, b in zip(flatten(st["opt"][name])[1],
                        flatten(sc["opt"][name])[1]):
            assert _rel_err(a.cpu(), b) <= 0.05, name
    assert int(st["step"]) == 1 == int(st["opt"]["count"])
