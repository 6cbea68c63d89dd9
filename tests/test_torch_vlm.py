"""PyTorch port: the vlm family (phi-3-vision-4.2b) held to the JAX package
on the CPU.

Two reduced configs, the same parameters in both packages: ``gqa`` (the
registry's ``.reduced()``: 2 layers, d_model 64, 4 q / 2 kv heads of hd
16, 4 patches of 32) and ``hd96`` (``.reduced(head_dim=96,
n_kv_heads=4)``: 4 q / 4 kv heads of hd 96, G = 1, the full model's head
shape).  Prefill with and without image patches, paged decode (after a
prefill with patches too), ``loss_fn`` and its gradients with patches
(``frontend/proj`` included) and on text, a train step with the int8
push, the serving engine's tokens against the JAX engine's (prefix
sharing, int8 KV, speculation), both launchers, and ``synthetic_batch``
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.synthetic import lm_batch_iterator as j_batches
from repro.data.synthetic import synthetic_batch as j_synthetic_batch
from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JKnobs
from repro.optim import make_optimizer as j_make_optimizer
from repro.ps.stepfn import StepKnobs as JStepKnobs
from repro.ps.stepfn import build_train_step as j_build_train_step
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.data.synthetic import (input_specs, lm_batch_iterator,
                                        synthetic_batch)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.lm import ModelKnobs
from repro_torch.optim import make_optimizer
from repro_torch.ps import stepfn
from repro_torch.ps.compression import compress_grads
from repro_torch.ps.stepfn import StepKnobs, build_train_step
from repro_torch.serving import Request, ServingEngine, serve_loop
from repro_torch.serving.pool import PagedKVPool, make_state_pool

from _torch_port import (LOGIT_TOL, _models, assert_decode_batch_matches_jax,
                         f32, tie_aware_check)

ARCH = "phi-3-vision-4.2b"
CONFIGS = {"gqa": {}, "hd96": {"head_dim": 96, "n_kv_heads": 4}}
# the JAX step's bounds (test_torch_train_step.py): the loss, and a leaf's
# gradient relative to its largest |value|
LOSS_TOL, GRAD_RTOL = 1e-2, 0.04
MAX_SEQ = 48
_MODELS: dict = {}


def vlm_models(name: str, seed: int = 0):
    """(jax cfg, port cfg, jax params, port params) of a reduced vlm
    config, cached per (name, seed)."""
    key = (name, seed)
    if key not in _MODELS:
        _MODELS[key] = _models(ARCH, seed, **CONFIGS[name])
    return _MODELS[key]


def _patches(cfg, B, seed):
    """(jax bf16, torch bf16) patches (B, frontend_len, frontend_dim)."""
    a = np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).bfloat16())


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("name", CONFIGS)
def test_params_carry_the_patch_projection(name):
    """The port's tree has JAX's keys and shapes, ``frontend/proj`` (F, D)
    among them; ``init_params`` draws it at JAX's scale (truncated normal
    over sqrt(F))."""
    cfg, tcfg, jp, tp = vlm_models(name)
    want = {k: np.asarray(v).shape
            for k, v in zip(*flatten(jax.tree_util.tree_map(np.asarray,
                                                            jp)))}
    shapes = dict(zip(*flatten(tlm.param_shapes(tcfg))))
    assert {k: tuple(v) for k, v in shapes.items()} == want
    assert want["frontend/proj"] == (cfg.frontend_dim, cfg.d_model)
    np.testing.assert_array_equal(f32(tp["frontend"]["proj"]),
                                  np.asarray(jp["frontend"]["proj"],
                                             np.float32))
    t = f32(tlm.init_params(tcfg, 3, device="cpu")["frontend"]["proj"])
    assert np.abs(t).max() <= 2.0 / np.sqrt(cfg.frontend_dim) + 1e-2
    assert abs(t.std() * np.sqrt(cfg.frontend_dim) - 0.880) < 0.05


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("with_patches", [False, True])
@pytest.mark.parametrize("S", [5, 19])
def test_prefill_logits_match_jax(name, with_patches, S):
    """Prefill of 2 prompts, with the patches before them or without:
    logits within LOGIT_TOL, the KV of all P + S positions within it."""
    cfg, tcfg, jp, tp = vlm_models(name)
    tok = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                            (2, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok)}
    fr = None
    if with_patches:
        jb["frontend"], fr = _patches(cfg, 2, S)
    jl, jc = jlm.prefill(jp, jb, cfg)
    tl, tc = tlm.prefill(tp, torch.from_numpy(tok).long(), tcfg,
                         frontend=fr)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    P = cfg.frontend_len if with_patches else 0
    assert tuple(tc["k"].shape) == jc["k"].shape == (
        cfg.n_layers, 2, P + S, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(f32(tc["v"]), f32(jc["v"]), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("S,dtype", [(1, "float32"), (1, "bfloat16"),
                                     (4, "bfloat16")])
def test_paged_decode_step_matches_jax(name, S, dtype):
    """One decode step (S = 1) and one 4-token chunked step over the same
    paged pool: logits within LOGIT_TOL, the KV written within it."""
    cfg, tcfg, jp, tp = vlm_models(name)
    rng = np.random.default_rng(11)
    bs, n_slots = 8, 4
    MB = -(-96 // bs)
    nb = n_slots * MB + 1
    shape = tlm.init_paged_cache_shapes(tcfg, nb, bs)["k"]
    kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    bt = (np.arange(n_slots * MB).reshape(n_slots, MB) + 1).astype(np.int32)
    jc = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in kv.items()}
    jc["block_tables"] = jnp.asarray(bt)
    tc = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in kv.items()}
    tc["block_tables"] = torch.from_numpy(bt)
    tok = rng.integers(0, cfg.vocab_size, (n_slots, S)).astype(np.int32)
    pos = np.array([3, 17, 30, 9], np.int32)
    jl, jc = jlm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), cfg,
                             None, JKnobs(attn_impl="paged"))
    tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), tcfg,
                             ModelKnobs(attn_impl="paged"))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(f32(tc["k"])[:, 1:], f32(jc["k"])[:, 1:],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_continues_a_prefill_with_patches(name):
    """Positions run over patches and text together: the port's prefill of
    P patches + T tokens, its KV written into a paged pool, then decode
    steps at positions P + T, P + T + 1, ... give the logits of the JAX
    package's prefill over the patches and the longer text (within
    LOGIT_TOL); a frontend in a decode step is refused."""
    cfg, tcfg, jp, tp = vlm_models(name)
    rng = np.random.default_rng(7)
    T, steps, bs = 9, 3, 8
    toks = rng.integers(0, cfg.vocab_size, (1, T + steps)).astype(np.int32)
    jfr, tfr = _patches(cfg, 1, 7)
    P = cfg.frontend_len
    _, pc = tlm.prefill(tp, torch.from_numpy(toks[:, :T]).long(), tcfg,
                        frontend=tfr)
    mb = -(-(P + T + steps) // bs)
    shape = tlm.init_paged_cache_shapes(tcfg, mb + 1, bs)["k"]
    cache = {k: torch.zeros(shape, dtype=torch.bfloat16) for k in "kv"}
    cache["block_tables"] = (torch.arange(mb) + 1)[None].to(torch.int32)
    rows = tlm.paged_rows(torch.arange(P + T)[None], cache["block_tables"],
                          bs)
    for k in "kv":
        cache[k][:, rows[0][0], rows[1][0]] = pc[k][:, 0]
    for j in range(steps):
        tl, cache = tlm.decode_step(
            tp, cache, torch.from_numpy(toks[:, T + j:T + j + 1]).long(),
            torch.tensor([P + T + j], dtype=torch.int32), tcfg)
        jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T + j + 1]),
                                 "frontend": jfr}, cfg)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    with pytest.raises(ValueError, match="tokens only"):
        tlm.forward(tp, torch.from_numpy(toks[:, :1]).long(), tcfg,
                    mode="decode", cache=cache,
                    pos=torch.tensor([0], dtype=torch.int32), frontend=tfr)


# ----------------------------------------------------------------- training
def _batch(cfg, seed, patches=True, B=2, S=11):
    rng = np.random.default_rng(seed)
    toks, labels = rng.integers(0, cfg.vocab_size, (2, B, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if patches:
        jb["frontend"], tb["frontend"] = _patches(cfg, B, seed + 100)
    return jb, tb


def _port_grads(tp, tcfg, batch, knobs):
    paths, pl = flatten(tp)
    ls = [p.detach().requires_grad_() for p in pl]
    loss, aux = tlm.loss_fn(unflatten(paths, ls), batch, tcfg, knobs)
    grads = torch.autograd.grad(loss, ls, allow_unused=True)
    return loss.detach(), aux, unflatten(
        paths, [torch.zeros_like(p) if g is None else g
                for p, g in zip(pl, grads)])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("patches,remat", [(True, "none"), (True, "dots"),
                                           (False, "none")])
def test_loss_and_grads_match_jax(name, patches, remat):
    """``loss_fn`` over the text positions behind the patches (or over a
    text batch) against ``jax.value_and_grad(lm.loss_fn)``: the loss within
    LOSS_TOL, every gradient leaf within 4% of its largest |value|;
    ``frontend/proj``'s gradient is nonzero with patches and zero (in both
    packages) without."""
    cfg, tcfg, jp, tp = vlm_models(name)
    jb, tb = _batch(cfg, 1 + patches, patches)
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jb, cfg, None, JKnobs(remat=remat))
    tl, _, tg = _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat))
    assert abs(float(jl) - float(tl)) <= LOSS_TOL
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jg))))
    for k, g in zip(*flatten(tg)):
        a = np.asarray(want[k], np.float32)
        assert np.abs(f32(g) - a).max() <= GRAD_RTOL * np.abs(a).max(), k
    proj = f32(tg["frontend"]["proj"])
    assert (np.abs(proj).max() > 0) == patches


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_step_matches_jax(compression, monkeypatch):
    """Two Adam steps of the reduced vlm at hd 96 in both packages from the
    same state on the same text batches (``lm_batch_iterator``, as both
    LMJobs draw them; the int8 push with the JAX package's uniforms
    injected, one quantize a leaf, ``frontend/proj``'s zero gradient
    among them): the loss within LOSS_TOL, new parameters within one
    bf16 step plus 2 lr a step, m within the gradient bound."""
    cfg, tcfg, jp, _ = vlm_models("hd96")
    jtc, ttc = JTrainConfig(), TrainConfig()
    opt_init, _ = j_make_optimizer(jtc)
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jstate),
                                    device="cpu")
    jstep = j_build_train_step(cfg, jtc, None,
                               JStepKnobs(compression=compression))
    tstep = build_train_step(tcfg, ttc, StepKnobs(compression=compression))
    calls = []
    if compression == "int8":
        def injected(grads, mode, step, uniforms=None):
            paths, gl = flatten(grads)
            keys = jax.random.split(jax.random.fold_in(
                jax.random.PRNGKey(17), int(step)), len(gl))
            us = [torch.from_numpy(np.array(jax.random.uniform(
                k, tuple(g.shape), jnp.float32))) for g, k in zip(gl, keys)]
            calls.append(len(gl))
            return compress_grads(grads, mode, step,
                                  uniforms=unflatten(paths, us))

        monkeypatch.setattr(stepfn, "compress_grads", injected)
    jb, tb = j_batches(cfg, 4, 16, seed=5), lm_batch_iterator(
        tcfg, 4, 16, seed=5, device="cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, next(jb))
        tstate, tm = tstep(tstate, next(tb))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL
    if compression == "int8":
        assert calls == [len(flatten(tstate["params"])[1])] * 2
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jstate))))
    got = dict(zip(*flatten(tstate)))
    lr = ttc.learning_rate
    for k, a in want.items():
        a = np.asarray(a, np.float32)
        if k.startswith("params/"):
            lim = 2 ** -7 * np.abs(a).max() + 2 * lr * 2
        elif k.startswith("opt/m/"):
            lim = GRAD_RTOL * np.abs(a).max()
        else:
            continue
        assert np.abs(f32(got[k]) - a).max() <= lim, k
    assert not f32(got["opt/m/frontend/proj"]).any()


def test_train_step_takes_patches_and_microbatches():
    """A batch with patches through ``build_train_step`` in two
    microbatches (the patches split with the tokens): the loss equals
    ``loss_fn``'s on the whole batch within f32 rounding, and the patch
    projection moves."""
    _, tcfg, _, tp = vlm_models("hd96")
    params = tree_map(torch.clone, tp)
    state = {"params": params, "opt": make_optimizer(TrainConfig())[0](
        params), "step": torch.zeros((), dtype=torch.int32)}
    batch = synthetic_batch(tcfg, ShapeConfig("t", 4 + 12, 4, "train"),
                            seed=2, device="cpu")
    want, _ = tlm.loss_fn(tp, batch, tcfg)
    before = state["params"]["frontend"]["proj"].clone()
    step = build_train_step(tcfg, TrainConfig(), StepKnobs(microbatches=2))
    state, m = step(state, batch)
    assert abs(float(m["loss"]) - float(want)) <= 1e-5
    assert not torch.equal(state["params"]["frontend"]["proj"], before)


# ------------------------------------------------------------------ serving
def _requests(vocab, cls):
    """Two prompts sharing a 16-token template (two blocks of 8), one that
    is the template whole (copy-on-write), two unrelated."""
    rng = np.random.default_rng(4)
    tpl = rng.integers(1, vocab, (16,)).astype(np.int32)
    prompts = [np.concatenate([tpl, rng.integers(1, vocab, (3,))
                               .astype(np.int32)]), tpl.copy(),
               np.concatenate([tpl, rng.integers(1, vocab, (5,))
                               .astype(np.int32)]),
               rng.integers(1, vocab, (11,)).astype(np.int32),
               rng.integers(1, vocab, (7,)).astype(np.int32)]
    return [cls(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("name,quant,spec_k", [("gqa", "none", 0),
                                               ("gqa", "int8", 3),
                                               ("hd96", "int8", 0),
                                               ("hd96", "none", 3)])
def test_engine_tokens_match_jax_engine(name, quant, spec_k):
    """The port's engine and the JAX engine on the same parameters and
    requests (tokens only, as the JAX engine serves vlm; prefix sharing on,
    4 slots, blocks of 8, int8 KV or not, the n-gram drafter or not): the
    same greedy tokens (tie-aware), the same prefill and sharing counts,
    no block leaked."""
    cfg, tcfg, jp, tp = vlm_models(name)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8,
                   prefix_share=True, quant=quant, spec_k=float(spec_k),
                   drafter="ngram")
    je = JEngine(jp, cfg, setting, max_seq=MAX_SEQ)
    je.async_precompile = False
    te = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    assert te.pool.kind == je.pool.kind == "paged"
    js = j_serve_loop(je, _requests(cfg.vocab_size, JRequest))
    ts = serve_loop(te, _requests(cfg.vocab_size, Request))
    assert ts["completed"] == js["completed"] == 5
    for k in ("prefill_tokens_computed", "prefill_tokens_total",
              "shared_blocks_hit", "cow_copies"):
        assert ts[k] == js[k], k
    assert ts["shared_blocks_hit"] > 0 and ts["cow_copies"] > 0
    if spec_k:
        assert te.spec_ticks > 0 and te.spec_drafted > 0
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for r in _requests(cfg.vocab_size, Request):
        assert len(tout[r.rid]) == r.max_new
        tie_aware_check(jp, cfg, r.prompt, jout[r.rid], tout[r.rid])
    te.pool.check_invariants()
    snap = te.pool.snapshot()
    assert te.pool.n_active == 0
    assert snap["blocks_held"] == snap["prefix_cached_blocks"]


def test_vlm_serves_through_the_paged_pool():
    _, tcfg, _, _ = vlm_models("hd96")
    pool = make_state_pool(tcfg, dict(DEFAULT_SERVING_SETTING), 32, "cpu")
    assert isinstance(pool, PagedKVPool) and pool.kind == "paged"
    assert pool.kv["k"].shape[-2:] == (tcfg.n_kv_heads, 96)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_the_vlm_on_cpu(launcher, capsys):
    """``launch/serve.py`` and ``launch/train.py --arch phi-3-vision-4.2b
    --reduced --device cpu`` end in OK."""
    if launcher == "serve":
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--rate", "40", "--duration", "0.2", "--gen",
                           "4", "--scenario", "shared_prefix"])
    else:
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "phi-3-vision" in out


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_synthetic_batch_matches_jax(arch, kind):
    """The same numpy draws in the same (sorted-key) order: tokens, labels
    and patches equal the JAX package's bit for bit; ``input_specs`` gives
    the text length behind the patches."""
    from repro.configs.registry import get_config as jget_config
    cfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    want = j_synthetic_batch(cfg, JShapeConfig("c", 20, 3, kind), seed=9)
    got = synthetic_batch(tcfg, ShapeConfig("c", 20, 3, kind), seed=9,
                          device="cpu")
    specs = input_specs(tcfg, ShapeConfig("c", 20, 3, kind))
    assert sorted(got) == sorted(want) == sorted(specs)
    for k, v in got.items():
        assert (tuple(v.shape), v.dtype) == specs[k]
        np.testing.assert_array_equal(f32(v), f32(want[k]))
    text = 20 - (cfg.frontend_len if arch == ARCH else 0)
    assert got["tokens"].shape == (3, text)


def test_synthetic_batch_decode_kind_is_not_ported():
    """The decode kind (once refused, since ported): tokens, pos and the
    dense per-slot cache of the vlm, bit for bit the JAX package's."""
    assert_decode_batch_matches_jax(ARCH)
