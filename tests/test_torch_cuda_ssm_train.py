"""PyTorch port on the card: the ssm and hybrid families' training path —
the selective scan's forward with interval checkpoints (``h_chk``) and its
backward kernel against autograd through the plain scan in f64, bit for
bit across calls, at every state size and at the backward's edges (a
ragged last block and a cluster with a block wholly past D, one block, S
ragged against the interval and the sub-interval, Bm and Cm at odd bf16
and f32 offsets, inputs by cp.async and through registers); the
backward's scratch the size its build plans; a zero dt passing the gradient through; bf16 views'
gradients; the kernels' launch counts in a reduced model's training step;
the remat settings giving equal gradients; and the flash backward at the
hybrid's training shape.  Every test here needs an NVIDIA GPU and skips
without one; ``python3 chip_smoke.py`` runs the same checks at full
width."""
import dataclasses
import re

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.core.tree import flatten, tree_map
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba_scan import (selective_scan,
                                            selective_scan_bwd,
                                            selective_scan_ref)
from repro_torch.kernels.mamba_scan.ref import scan_checkpoints_ref
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.models.mamba import SelectiveScan
from repro_torch.ps.stepfn import _grads

pytestmark = pytest.mark.cuda

SCAN_TOL = 1e-4      # the forward's states: f32 rounding of ex2.approx
                     # against exp over <= 512 steps (as chip_smoke.py)
BWD_RTOL = 2e-2      # the flash backward against the plain version
                     # (test_torch_cuda_train.py's bound)
# A reduced model's gradients on the card against the same step on the
# CPU (plain versions), relative to a leaf's largest |value|: the flash
# kernels round P and dS to bf16 block by block where the CPU's blocked
# attention does not, and bf16 activations carry that through the layers.
TRAIN_RTOL = 5e-2
# The backward against f64, beside twice the f32 plain version's gap: where
# that gap is half an f32 ulp of the largest value (f32 outputs, a short S:
# 4.6e-8 at S = 5), the kernel's ex2.approx (relative error ~2^-22) and
# its own sum orders add a few f32 ulps (1.2e-7 there), so 4 ulps are
# allowed on top; chip_smoke.py holds the training shapes to 2x alone.
F32_ULPS = 4 * 2.0 ** -24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def scan_inputs(dev, B, S, D, N, form, seed=0):
    """x, dt, Bm, Cm, A as the models hand them over: ``views`` is
    falcon-mamba's (x, dt bf16; Bm, Cm bf16 views of an x_proj output),
    ``f32`` zamba2's (everything f32, Bm, Cm f32 views), ``bf16`` all bf16
    and contiguous; ``odd`` as ``views`` with 3 columns before Bm, so Bm
    and Cm start, and their rows step, at odd bf16 offsets (2-byte
    aligned); ``odd_f32`` as ``f32`` with those 3 columns (4-byte aligned,
    so the backward stages Bm and Cm through registers).  A = -(1..N)
    (falcon-mamba's init)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    io = f32 if form in ("f32", "odd_f32") else bf16
    x = torch.randn((B, S, D), generator=g, device=dev).to(io)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, D), generator=g, device=dev) - 1.0).to(io)
    if form == "bf16":
        Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev).to(bf16)
                  for _ in range(2))
    else:
        R = 3 if form in ("odd", "odd_f32") else 8
        proj = torch.randn((B, S, R + 2 * N), generator=g, device=dev).to(io)
        _, Bm, Cm = proj.split([R, N, N], dim=-1)
    A = -torch.arange(1, N + 1, dtype=f32, device=dev).expand(D, N)
    return x, dt, Bm, Cm, A.contiguous()


def scan_f64(x, dt, Bm, Cm, A, h0=None):
    """The plain recurrence in f64 (``selective_scan_ref``'s loop)."""
    B, S, D = x.shape
    h = (torch.zeros((B, D, A.shape[1]), dtype=torch.float64,
                     device=x.device) if h0 is None else h0)
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1)


def plain_grads(ins, gy, dtype, h0=None):
    """Gradients of y . gy by autograd through the plain scan in ``dtype``:
    f64, the reference, kept in f64; f32 (``selective_scan_ref``), each
    cast to its input's dtype as the kernel returns it (gB, gC to Bm's),
    so its gap to f64 counts the same output rounding as the kernel's."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in ins]
    h = None if h0 is None else h0.detach().to(dtype).requires_grad_()
    with torch.enable_grad():
        if dtype == torch.float64:
            y = scan_f64(*leaves, h0=h)
        else:
            y, _ = selective_scan_ref(*leaves, h)
        g = torch.autograd.grad(y, leaves + ([h] if h0 is not None else []),
                                gy.to(dtype))
    if dtype == torch.float64:
        return list(g)
    outs = [a.to(t.dtype) for a, t in zip(g[:4], ins[:2] + (ins[2],) * 2)]
    return outs + [g[4].float()] + ([g[5].float()] if h0 is not None else [])


def kernel_grads(ins, gy, L, h0=None):
    x, dt, Bm, Cm, A = ins
    B, S, D = x.shape
    h_chk = torch.empty((B, -(-S // L), D, A.shape[1]), device=x.device)
    selective_scan(x, dt, Bm, Cm, A, h0, h_chk=h_chk, chunk=L)
    out = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=L,
                             want_gh0=h0 is not None)
    return [t for t in out if t is not None]


SCAN_CASES = {
    "falcon_views": (2, 200, 1024, 16, "views", 64),
    "zamba2_f32": (2, 256, 512, 64, "f32", 64),
    "ragged_chunk32": (1, 37, 1024, 16, "views", 32),
    "short_direct": (2, 5, 512, 64, "f32", 64),
    # named for its earlier interval of 192; the backward takes intervals
    # of 32 and 64 (CHK_STEPS), the longest it stages whole
    "bf16_chunk192": (1, 300, 256, 16, "bf16", 64),
    "n4_f32": (2, 70, 512, 4, "f32", 32),
    "n8_views": (1, 90, 256, 8, "views", 64),
    "n32_f32": (2, 100, 256, 32, "f32", 32),
    # the backward's edges: 21 blocks of 32 d's in clusters of 2, the last
    # block holding 20 d's and the last cluster's second block wholly past
    # D; one block (a cluster of one) with D = 42, not a multiple of 4, so
    # dt, x and gy go through registers while Bm and Cm go by cp.async;
    # S = 141 ragged against the interval (64) and the sub-interval (8);
    # Bm, Cm at odd bf16 offsets, and at an f32 offset of 12 bytes (through
    # registers while dt, x and gy go by cp.async)
    "ragged_cluster": (2, 70, 660, 32, "f32", 64),
    "one_block": (2, 50, 42, 8, "f32", 32),
    "ragged_steps": (2, 141, 1024, 16, "views", 64),
    "odd_views": (2, 100, 512, 16, "odd", 64),
    "odd_views_n64": (1, 90, 256, 64, "odd", 32),
    "odd_f32_n64": (1, 77, 256, 64, "odd_f32", 64),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_checkpoints_leave_the_forward_as_it_was(dev, case):
    """h_chk holds the plain version's state before each interval; y and
    h_out are the same bits with and without it."""
    B, S, D, N, form, L = SCAN_CASES[case]
    x, dt, Bm, Cm, A = scan_inputs(dev, B, S, D, N, form)
    h0 = torch.randn((B, D, N), device=dev)
    for h in (None, h0):
        y0, hl0 = selective_scan(x, dt, Bm, Cm, A, h)
        h_chk = torch.full((B, -(-S // L), D, N), float("nan"), device=dev)
        y1, hl1 = selective_scan(x, dt, Bm, Cm, A, h, h_chk=h_chk, chunk=L)
        torch.cuda.synchronize()
        assert torch.equal(y0, y1) and torch.equal(hl0, hl1)
        _, _, want = scan_checkpoints_ref(x, dt, Bm, Cm, A, h, L)
        assert float((h_chk - want).abs().max()) <= SCAN_TOL


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_backward_matches_f64(dev, case):
    """Every gradient of the backward kernel against autograd through the
    plain scan in f64, within twice the f32 plain version's own gap to it
    plus F32_ULPS (each relative to the gradient's largest |value|; the
    kernel and the f32 plain version both round to the output's dtype);
    two calls give the same bits (no atomics)."""
    B, S, D, N, form, L = SCAN_CASES[case]
    ins = scan_inputs(dev, B, S, D, N, form, seed=1)
    gy = torch.randn((B, S, D), device=dev)
    reset_launches()
    got = kernel_grads(ins, gy, L)
    again = kernel_grads(ins, gy, L)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan_bwd"] == 2
    want = plain_grads(ins, gy, torch.float64)
    plain = plain_grads(ins, gy, torch.float32)
    names = ("gx", "gdt", "gB", "gC", "gA")
    for name, k, w, p, a in zip(names, got, want, plain, again):
        assert k.shape == w.shape and k.dtype == p.dtype, name
        assert torch.equal(k, a), name
        assert torch.isfinite(k.float()).all(), name
        err, floor = _rel_err(k, w), _rel_err(p, w)
        assert err <= 2 * floor + F32_ULPS, (name, err, floor)


@pytest.mark.parametrize("case", ["falcon_views", "ragged_cluster",
                                  "one_block"])
def test_scan_backward_scratch_is_the_plans(dev, case, monkeypatch):
    """The wrapper's one scratch tensor has the elements the build plans
    (``bwd_scratch``, the kernel's ``selective_scan_bwd_scratch``): one gB
    and gC row a cluster of blocks along d, as kMaxDB and kCluster in the
    source give them, and none for gA."""
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    B, S, D, N, form, L = SCAN_CASES[case]
    ins = scan_inputs(dev, B, S, D, N, form, seed=5)
    gy = torch.randn((B, S, D), device=dev)
    h_chk = torch.empty((B, -(-S // L), D, N), device=dev)
    selective_scan(*ins, h_chk=h_chk, chunk=L)
    sizes, empty = [], torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy)
    selective_scan_bwd(*ins, h_chk, gy, chunk=L)
    monkeypatch.setattr(torch, "empty", empty)
    torch.cuda.synchronize()
    src = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    max_db, max_cluster = (
        int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
        for n in ("kMaxDB", "kCluster"))
    nblk = -(-D // min(max_db, 1024 // N))
    cluster = 1
    while cluster < max_cluster and cluster < nblk:
        cluster *= 2
    want = 2 * B * -(-nblk // cluster) * S * N
    assert scan_kernel.bwd_scratch(B, S, D, N) == want
    assert [sz for sz in sizes if len(sz) == 1] == [(want,)]


def test_scan_backward_gives_the_initial_states_gradient(dev):
    B, S, D, N = 2, 150, 512, 16
    ins = scan_inputs(dev, B, S, D, N, "f32", seed=2)
    h0 = torch.randn((B, D, N), device=dev)
    gy = torch.randn((B, S, D), device=dev)
    got = kernel_grads(ins, gy, 64, h0=h0)
    want = plain_grads(ins, gy, torch.float64, h0=h0)
    plain = plain_grads(ins, gy, torch.float32, h0=h0)
    assert _rel_err(got[5], want[5]) <= (2 * _rel_err(plain[5], want[5])
                                         + F32_ULPS)


def test_zero_dt_passes_the_gradient_through(dev):
    """Right padding as the model pads (dt = 0, no cotangent past the
    valid steps): the valid steps' gradients are the unpadded call's, bit
    for bit, and the padded steps get none."""
    B, S, D, N, valid = 2, 160, 512, 16, 131
    x, dt, Bm, Cm, A = scan_inputs(dev, B, S, D, N, "views", seed=3)
    dt = dt.clone()
    dt[:, valid:] = 0
    gy = torch.randn((B, S, D), device=dev)
    gy[:, valid:] = 0
    full = kernel_grads((x, dt, Bm, Cm, A), gy, 64)
    cut = kernel_grads((x[:, :valid].contiguous(), dt[:, :valid].contiguous(),
                        Bm[:, :valid], Cm[:, :valid], A),
                       gy[:, :valid].contiguous(), 64)
    for a, b in zip(full[:4], cut[:4]):
        assert torch.equal(a[:, :valid], b)
    assert torch.equal(full[4], cut[4])
    for a in (full[0], full[2], full[3]):
        assert not a[:, valid:].any()


def test_selective_scan_function_views_and_checkpoint(dev):
    """``SelectiveScan`` on falcon-mamba's form: Bm and Cm bf16 views of
    one x_proj output get back (B, S, N) bf16 gradients into it; under
    ``torch.utils.checkpoint`` the forward runs again and the gradients
    are the same bits."""
    from torch.utils.checkpoint import checkpoint
    B, S, D, N, R = 2, 96, 1024, 16, 8
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, D), generator=g, device=dev)).to(torch.bfloat16)
    proj = torch.randn((B, S, R + 2 * N), generator=g,
                       device=dev).to(torch.bfloat16)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(D, N).contiguous()
    gy = torch.randn((B, S, D), generator=g, device=dev)

    def f(x, dt, proj, A):
        _, Bm, Cm = proj.split([R, N, N], dim=-1)
        return SelectiveScan.apply(x, dt, Bm, Cm, A)

    outs = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_() for t in (x, dt, proj, A)]
        reset_launches()
        y = (checkpoint(f, *leaves, use_reentrant=False) if remat
             else f(*leaves))
        gr = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        assert LAUNCHES["selective_scan"] == (2 if remat else 1)
        assert LAUNCHES["selective_scan_bwd"] == 1
        assert gr[2].dtype == torch.bfloat16 and not gr[2][..., :R].any()
        outs.append(gr)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    want = plain_grads((x, dt, Bm, Cm, A), gy, torch.float64)
    plain = plain_grads((x, dt, Bm, Cm, A), gy, torch.float32)
    for k, w, p in zip((outs[0][2][..., R:R + N], outs[0][2][..., R + N:]),
                       want[2:4], plain[2:4]):
        assert _rel_err(k, w) <= 2 * _rel_err(p, w)


def _card_cfg(arch, n_layers):
    """A small config of the family at the kernels' sizes: hd 64 for the
    hybrid's shared attention (a flash build), N 64 for mamba2."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return cfg.reduced(d_model=256, n_heads=4, n_kv_heads=4,
                           head_dim=64, d_ff=512, vocab_size=512,
                           ssm_state=64, ssm_head_dim=64, n_layers=n_layers)
    return cfg.reduced(d_model=256, vocab_size=512, n_layers=n_layers)


def _batch(cfg, dev, B=2, S=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab_size, (2, B, S), generator=g)
    return {"tokens": t[0].to(dev), "labels": t[1].to(dev)}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_reduced_model_trains_through_the_kernels(dev, arch):
    """One loss and gradient of a reduced model on the card (the scan's
    forward and backward kernels, the hybrid's flash kernels) against the
    same on the CPU (plain versions) from the same parameters and batch;
    at 3 layers every layer launches each scan kernel once and each
    application of the shared block each flash kernel once."""
    cfg = _card_cfg(arch, 1)
    params = lm.init_params(cfg, seed=0, device=dev)
    batch = _batch(cfg, dev)
    reset_launches()
    loss, _, g = _grads(params, batch, cfg, ModelKnobs())
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == LAUNCHES["selective_scan_bwd"] == 1
    pc = tree_map(lambda t: t.cpu(), params)
    lc, _, gc = _grads(pc, {k: v.cpu() for k, v in batch.items()}, cfg,
                       ModelKnobs())
    assert abs(float(loss) - float(lc)) <= 1e-2
    for p, a, b in zip(flatten(g)[0], flatten(g)[1], flatten(gc)[1]):
        assert torch.isfinite(a.float()).all(), p
        assert _rel_err(a.cpu(), b) <= TRAIN_RTOL, (p, _rel_err(a.cpu(), b))

    cfg3 = dataclasses.replace(cfg, n_layers=3)
    params = lm.init_params(cfg3, seed=0, device=dev)
    reset_launches()
    _grads(params, batch, cfg3, ModelKnobs())
    torch.cuda.synchronize()
    apps = lm.n_shared_apps(cfg3) if cfg3.family == "hybrid" else 0
    assert LAUNCHES["selective_scan"] == LAUNCHES["selective_scan_bwd"] == 3
    assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_bwd"] \
        == apps


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_remat_settings_give_the_same_gradients(dev, arch):
    """remat none, dots and full change what is kept for the backward, not
    the arithmetic: the same loss and gradients, bit for bit; under dots
    and full the scan's forward runs again in the backward (twice a
    layer).  A recomputation that handed back a stale buffer instead of
    launching again would show here."""
    cfg = _card_cfg(arch, 2)
    params = lm.init_params(cfg, seed=1, device=dev)
    batch = _batch(cfg, dev, seed=1)
    base = None
    for remat in ("none", "dots", "full"):
        reset_launches()
        loss, _, g = _grads(params, batch, cfg, ModelKnobs(remat=remat))
        torch.cuda.synchronize()
        want = cfg.n_layers * (1 if remat == "none" else 2)
        assert LAUNCHES["selective_scan"] == want, remat
        assert LAUNCHES["selective_scan_bwd"] == cfg.n_layers
        got = [loss] + flatten(g)[1]
        if base is None:
            base = got
            continue
        for a, b in zip(base, got):
            assert torch.equal(a, b), remat


def test_flash_backward_at_the_hybrid_training_shape(dev):
    """zamba2's shared block in training: (4, 512, 32/32, 64), causal,
    G = 1, against autograd through the plain version; bit for bit across
    two calls."""
    B, S, H, hd = 4, 512, 32, 64
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn((B, S, H, hd), generator=g,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    want = attention_bwd_ref(q, k, v, do, pos, pos)
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and torch.equal(a, c)
        assert _rel_err(a, b) <= BWD_RTOL
