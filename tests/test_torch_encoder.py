"""PyTorch port: the encoder family (hubert-xlarge) held to the JAX package
on the CPU.

Two reduced configs, the same parameters in both packages: ``gqa`` (the
registry's ``.reduced()``: 2 layers, d_model 64, 4 q / 2 kv heads of hd
16, frames 32 wide) and ``hd80`` (``.reduced(n_kv_heads=4,
head_dim=80)``: 4 q / 4 kv heads of hd 80, G = 1, the full model's head
shape).  The frames' projection, the encode (prefill hidden states and
every frame's logits), ``loss_fn`` over every frame and its gradients
(``embed/tokens``'s zero among them), a train step, the non-causal
attention at hd 80 against the JAX package's ``chunked_attention`` and
its Pallas kernel, the frame batches and the paper-workload datasets bit
for bit, and the refusals of what has no decode step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import image_dataset as j_image_dataset
from repro.data.synthetic import regression_dataset as j_regression_dataset
from repro.data.synthetic import synthetic_batch as j_synthetic_batch
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.models import lm as jlm
from repro.models.attention import chunked_attention as j_chunked_attention
from repro.models.lm import ModelKnobs as JKnobs
from repro.optim import make_optimizer as j_make_optimizer
from repro.ps.stepfn import StepKnobs as JStepKnobs
from repro.ps.stepfn import build_train_step as j_build_train_step
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro.serving.pool import make_state_pool as j_make_state_pool
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.data.synthetic import (image_dataset, input_specs,
                                        regression_dataset, synthetic_batch)
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models.attention import blocked_attention
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.lm import ModelKnobs
from repro_torch.optim import make_optimizer
from repro_torch.ps.stepfn import StepKnobs, build_train_step
from repro_torch.serving import ServingEngine
from repro_torch.serving.pool import PagedKVPool, make_state_pool

from _torch_port import (LOGIT_TOL, _models, assert_decode_batch_matches_jax,
                         f32)

ARCH = "hubert-xlarge"
CONFIGS = {"gqa": {}, "hd80": {"head_dim": 80, "n_kv_heads": 4}}
# the vlm tests' bounds: the loss, and a leaf's gradient relative to its
# largest |value| (XLA and PyTorch round some bf16 products a step apart)
LOSS_TOL, GRAD_RTOL = 1e-2, 0.04
# the projected frames (|x| < 4): one bf16 step of the largest value,
# where XLA and PyTorch sum the 32 products in another order
EMBED_TOL = 2 ** -6
# attention outputs, port against JAX or Pallas: one bf16 step at |x| < 4
# (the JAX attention rounds P to bf16 for P.V; the plain version does not)
ATTN_TOL = 2e-2
_MODELS: dict = {}


def enc_models(name: str, seed: int = 0):
    """(jax cfg, port cfg, jax params, port params) of a reduced encoder
    config, cached per (name, seed)."""
    key = (name, seed)
    if key not in _MODELS:
        _MODELS[key] = _models(ARCH, seed, **CONFIGS[name])
    return _MODELS[key]


def _frames(cfg, B, S, seed):
    """(jax bf16, torch bf16) frames (B, S, frontend_dim)."""
    a = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.frontend_dim)).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _batch(cfg, seed, B=2, S=11):
    """A training batch of frames with a label each, in both packages."""
    jfr, tfr = _frames(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size,
                                                      (B, S))
    return ({"frontend": jfr, "labels": jnp.asarray(labels, jnp.int32)},
            {"frontend": tfr, "labels": torch.from_numpy(labels)})


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("name", CONFIGS)
def test_params_carry_the_frame_projection(name):
    """The port's tree has JAX's keys and shapes (``frontend/proj`` (F, D),
    the untied ``lm_head/w`` (D, V) and the unused ``embed/tokens``) and
    the converted leaves are JAX's bit for bit."""
    cfg, tcfg, jp, tp = enc_models(name)
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jp))))
    shapes = dict(zip(*flatten(tlm.param_shapes(tcfg))))
    assert {k: tuple(v) for k, v in shapes.items()} == {
        k: v.shape for k, v in want.items()}
    assert shapes["frontend/proj"] == (cfg.frontend_dim, cfg.d_model)
    assert shapes["lm_head/w"] == (cfg.d_model, cfg.vocab_size)
    assert shapes["embed/tokens"] == (cfg.vocab_size, cfg.d_model)
    for k, t in zip(*flatten(tp)):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(f32(t), np.asarray(want[k], np.float32))
    assert cfg.causal is tcfg.causal is False


@pytest.mark.parametrize("name", CONFIGS)
def test_frame_embed_matches_jax(name):
    """The frames through ``frontend/proj`` in bf16, no token read: within
    one bf16 step of JAX's ``_embed``; a frame model without frames is
    refused."""
    cfg, tcfg, jp, tp = enc_models(name)
    jfr, tfr = _frames(cfg, 2, 13, 3)
    want = jlm._embed(jp, cfg, {"frontend": jfr}, None)
    got = tlm._embed(tp, tcfg, None, tfr)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=EMBED_TOL, rtol=0)
    with pytest.raises(ValueError, match="frames"):
        tlm._embed(tp, tcfg, None, None)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("S", [7, 40])
def test_encode_matches_jax(name, S):
    """The encode: ``forward(mode="prefill")`` over frames with
    ``tokens=None`` and ``logits_fn`` over every frame, against JAX's
    ``forward(mode="prefill")`` + ``logits_fn``: hidden states and logits
    within LOGIT_TOL; ``prefill``'s last-frame logits and the stacked KV
    of every layer as JAX's."""
    cfg, tcfg, jp, tp = enc_models(name)
    jfr, tfr = _frames(cfg, 2, S, S)
    jh, _, jc = jlm.forward(jp, {"frontend": jfr}, cfg, mode="prefill")
    th, tc = tlm.forward(tp, None, tcfg, mode="prefill", frontend=tfr)
    np.testing.assert_allclose(f32(th), f32(jh), atol=LOGIT_TOL, rtol=0)
    jl = jlm.logits_fn(jp, jh, cfg)
    tl = tlm.logits_fn(tp, th, tcfg)
    assert tuple(tl.shape) == jl.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert tuple(tc["k"].shape) == jc["k"].shape == (
        cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(f32(tc["v"]), f32(jc["v"]), atol=LOGIT_TOL,
                               rtol=0)
    pl, _ = tlm.prefill(tp, None, tcfg, frontend=tfr)
    jpl, _ = jlm.prefill(jp, {"frontend": jfr}, cfg)
    np.testing.assert_allclose(f32(pl), f32(jpl), atol=LOGIT_TOL, rtol=0)


def test_encode_is_not_causal():
    """Attention over frames is bidirectional: flipping the last frame
    changes the first frame's hidden state."""
    _, tcfg, _, tp = enc_models("gqa")
    _, fr = _frames(tcfg, 1, 12, 5)
    h, _ = tlm.forward(tp, None, tcfg, mode="prefill", frontend=fr)
    fr2 = fr.clone()
    fr2[:, -1] = -fr2[:, -1]
    h2, _ = tlm.forward(tp, None, tcfg, mode="prefill", frontend=fr2)
    assert not torch.equal(h[:, 0], h2[:, 0])


def _port_grads(tp, tcfg, batch, knobs):
    paths, pl = flatten(tp)
    ls = [p.detach().requires_grad_() for p in pl]
    loss, aux = tlm.loss_fn(unflatten(paths, ls), batch, tcfg, knobs)
    grads = torch.autograd.grad(loss, ls, allow_unused=True)
    return loss.detach(), aux, unflatten(
        paths, [torch.zeros_like(p) if g is None else g
                for p, g in zip(pl, grads)])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("remat,ce_chunk", [("none", 0), ("dots", 0),
                                            ("full", 4)])
def test_loss_and_grads_match_jax(name, remat, ce_chunk):
    """``loss_fn`` over every frame against ``jax.value_and_grad(
    lm.loss_fn)``: the loss within LOSS_TOL, every gradient leaf within 4%
    of its largest |value| (``frontend/proj`` nonzero); ``embed/tokens``,
    which a frame batch never reads, gets a zero gradient in both."""
    cfg, tcfg, jp, tp = enc_models(name)
    jb, tb = _batch(cfg, 7, S=12)
    (jl, jaux), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jb, cfg, None, JKnobs(remat=remat, ce_chunk=ce_chunk))
    tl, taux, tg = _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat,
                                                        ce_chunk=ce_chunk))
    assert abs(float(jl) - float(tl)) <= LOSS_TOL
    assert abs(float(jaux["ce"]) - float(taux["ce"].detach())) <= LOSS_TOL
    assert float(taux["aux"]) == 0.0
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jg))))
    for k, g in zip(*flatten(tg)):
        a = np.asarray(want[k], np.float32)
        assert np.abs(f32(g) - a).max() <= GRAD_RTOL * np.abs(a).max(), k
    assert not np.asarray(want["embed/tokens"], np.float32).any()
    assert not f32(tg["embed"]["tokens"]).any()
    assert np.abs(f32(tg["frontend"]["proj"])).max() > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_jax(name):
    """An Adam step of ``build_train_step`` in both packages from the same
    state on the same ``synthetic_batch`` frame batch: the loss within
    LOSS_TOL, new parameters within one bf16 step plus 2 lr, m within the
    gradient bound; ``embed/tokens`` does not move."""
    cfg, tcfg, jp, _ = enc_models(name)
    jtc, ttc = JTrainConfig(), TrainConfig()
    opt_init, _ = j_make_optimizer(jtc)
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jstate),
                                    device="cpu")
    jstep = jax.jit(j_build_train_step(cfg, jtc, None, JStepKnobs()))
    tstep = build_train_step(tcfg, ttc, StepKnobs())
    jb = j_synthetic_batch(cfg, JShapeConfig("t", 16, 2, "train"), seed=1)
    tb = synthetic_batch(tcfg, ShapeConfig("t", 16, 2, "train"), seed=1,
                         device="cpu")
    jstate, jm = jstep(jstate, jb)
    tstate, tm = tstep(tstate, tb)
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jstate))))
    got = dict(zip(*flatten(tstate)))
    lr = ttc.learning_rate
    for k, a in want.items():
        a = np.asarray(a, np.float32)
        if k.startswith("params/"):
            lim = 2 ** -7 * np.abs(a).max() + 2 * lr
        elif k.startswith("opt/m/"):
            lim = GRAD_RTOL * np.abs(a).max()
        else:
            continue
        assert np.abs(f32(got[k]) - a).max() <= lim, k
    np.testing.assert_array_equal(f32(got["params/embed/tokens"]),
                                  np.asarray(jp["embed"]["tokens"],
                                             np.float32))
    assert int(got["step"]) == 1


def test_train_step_takes_frames_in_microbatches():
    """A frame batch through ``build_train_step`` in two microbatches (the
    frames split with their labels): the loss equals ``loss_fn``'s on the
    whole batch within f32 rounding, and the frame projection moves."""
    _, tcfg, _, tp = enc_models("hd80")
    params = tree_map(torch.clone, tp)
    state = {"params": params, "opt": make_optimizer(TrainConfig())[0](
        params), "step": torch.zeros((), dtype=torch.int32)}
    batch = synthetic_batch(tcfg, ShapeConfig("t", 10, 4, "train"), seed=2,
                            device="cpu")
    want, _ = tlm.loss_fn(tp, batch, tcfg)
    before = state["params"]["frontend"]["proj"].clone()
    step = build_train_step(tcfg, TrainConfig(), StepKnobs(microbatches=2))
    state, m = step(state, batch)
    assert abs(float(m["loss"]) - float(want)) <= 1e-5
    assert not torch.equal(state["params"]["frontend"]["proj"], before)


# -------------------------------------------------------------- attention
def _qkv(B, Sq, Skv, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd))]


@pytest.mark.parametrize("S,k_chunk,H,K", [(100, 32, 4, 4), (100, 64, 4, 4),
                                           (64, 32, 4, 2), (130, 64, 2, 2)])
@pytest.mark.parametrize("shift", [0, 20])
def test_noncausal_attention_matches_jax_at_hd80(S, k_chunk, H, K, shift):
    """hd 80, not causal: ``blocked_attention`` (the CPU prefill and
    training attention) against the JAX package's ``chunked_attention``
    at ragged S and k_chunk 32 / 64 (halved until it divides S), and
    against the port's plain ``attention_ref``; with ``shift`` the keys'
    positions start at -shift, and keys at negative positions are masked
    in all three."""
    q, k, v = _qkv(2, S, S, H, K, 80, S + k_chunk)
    pos = np.broadcast_to(np.arange(S) - shift, (2, S)).astype(np.int32)
    want = j_chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=False,
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        k_chunk=k_chunk)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tpos = torch.from_numpy(pos.copy()).long()
    got = blocked_attention(tq, tk, tv, causal=False, q_positions=tpos,
                            kv_positions=tpos, k_chunk=k_chunk)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    ref = attention_ref(tq, tk, tv, tpos, tpos, causal=False)
    np.testing.assert_allclose(f32(ref), f32(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("Sq,Skv", [(128, 128), (64, 192)])
def test_noncausal_attention_matches_pallas_at_hd80(Sq, Skv):
    """hd 80, not causal, G = 1: the port's plain version against the
    Pallas flash kernel in interpret mode at blocks of 64 (positions from
    0, which neither masks)."""
    q, k, v = _qkv(1, Sq, Skv, 2, 2, 80, Sq + Skv)
    ker = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  causal=False, block_q=64, block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    ref = attention_ref(tq, tk, tv, causal=False)
    np.testing.assert_allclose(f32(ref), f32(ker), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_synthetic_frame_batch_matches_jax(kind):
    """The frame kinds: ``{frontend (B, S, F) bf16, labels (B, S)}`` in
    training and ``{frontend}`` in prefill, no tokens, drawn as the JAX
    package draws them, bit for bit; the decode kind (a shape cell the
    dry run never takes for the encoder, which has no decode step) as the
    JAX package builds it, bit for bit."""
    cfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = j_synthetic_batch(cfg, JShapeConfig("c", 20, 3, kind), seed=9)
    got = synthetic_batch(tcfg, ShapeConfig("c", 20, 3, kind), seed=9,
                          device="cpu")
    specs = input_specs(tcfg, ShapeConfig("c", 20, 3, kind))
    assert sorted(got) == sorted(want) == sorted(specs) == (
        ["frontend", "labels"] if kind == "train" else ["frontend"])
    for k, v in got.items():
        assert (tuple(v.shape), v.dtype) == specs[k]
        np.testing.assert_array_equal(f32(v), f32(want[k]))
    assert got["frontend"].shape == (3, 20, cfg.frontend_dim)
    assert_decode_batch_matches_jax(ARCH)


@pytest.mark.parametrize("task,cond", [("logreg", 1.0), ("logreg", 100.0),
                                       ("svm", 1.0), ("svm", 30.0)])
def test_regression_dataset_matches_jax(task, cond):
    """The LogR / SVM data (ill-conditioned with ``cond`` > 1), bit for
    bit: X f32, y in {0, 1} (logreg) or +-1 (svm)."""
    jX, jy = j_regression_dataset(n=300, d=17, seed=4, task=task, cond=cond)
    X, y = regression_dataset(n=300, d=17, seed=4, task=task, cond=cond,
                              device="cpu")
    assert X.dtype == y.dtype == torch.float32
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert set(np.unique(y.numpy())) <= ({0.0, 1.0} if task == "logreg"
                                         else {-1.0, 1.0})


def test_image_dataset_matches_jax():
    """The CNN analogue's images and labels, bit for bit."""
    jx, jy = j_image_dataset(n=64, hw=8, n_classes=5, seed=3)
    x, y = image_dataset(n=64, hw=8, n_classes=5, seed=3, device="cpu")
    assert tuple(x.shape) == (64, 8, 8, 3) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("what", ["engine", "pool", "paged_pool",
                                  "paged_cache", "decode"])
def test_what_decodes_refuses_the_encoder(what):
    """The engine and the state pools refuse the encoder, as the JAX
    package's do, with its text; so do the paged cache shapes and a decode
    step."""
    cfg, tcfg, jp, tp = enc_models("gqa")
    setting = dict(DEFAULT_SERVING_SETTING)
    msg = "encoder-only models have no decode step"
    if what == "engine":
        with pytest.raises(NotImplementedError, match=msg):
            JEngine(jp, cfg, setting, max_seq=32)
    if what == "pool":
        with pytest.raises(NotImplementedError, match=msg):
            j_make_state_pool(cfg, setting, 32)
    call = {
        "engine": lambda: ServingEngine(tp, tcfg, setting, max_seq=32,
                                        device="cpu"),
        "pool": lambda: make_state_pool(tcfg, setting, 32, "cpu"),
        "paged_pool": lambda: PagedKVPool(tcfg, setting, 32, "cpu"),
        "paged_cache": lambda: tlm.init_paged_cache_shapes(tcfg, 9, 8),
        "decode": lambda: tlm.decode_step(
            tp, {}, torch.zeros((1, 1), dtype=torch.int64),
            torch.zeros(1, dtype=torch.int32), tcfg),
    }[what]
    with pytest.raises(NotImplementedError, match=msg):
        call()


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_refuse_the_encoder(launcher):
    """``launch/serve.py`` exits as the JAX launcher does ("encoder-only
    arch has no decode step"); ``launch/train.py``, whose job feeds token
    batches, exits before it builds the model and says why."""
    if launcher == "serve":
        with pytest.raises(SystemExit, match="no decode step"):
            launch_serve.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu"])
    else:
        with pytest.raises(SystemExit, match="reads frames"):
            launch_train.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu", "--steps", "1"])
