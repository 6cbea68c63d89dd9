"""PyTorch port: the training step held to the JAX package on the CPU.

Reduced starcoder2-3b (2 layers, d_model 64, 4 q / 2 kv heads, hd 16),
the same parameters and batches in both packages: ``loss_fn`` and its
gradients against ``jax.value_and_grad(lm.loss_fn)``; the port's three
remat modes against each other; and one ``build_train_step`` run per knob
value against the JAX step from the same state on the same batches (with
the JAX package's int8 uniforms injected)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.synthetic import lm_batch_iterator as j_batches
from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JModelKnobs
from repro.optim import make_optimizer as j_make_optimizer
from repro.ps.stepfn import StepKnobs as JStepKnobs
from repro.ps.stepfn import build_train_step as j_build_train_step
from repro.ps.stepfn import train_state_shapes as j_train_state_shapes
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import flatten, unflatten
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.models import lm
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.lm import ModelKnobs
from repro_torch.ps import stepfn
from repro_torch.ps.compression import compress_grads
from repro_torch.ps.stepfn import (StepKnobs, build_train_step,
                                   train_state_shapes)

from _torch_port import dense_models, f32

# The loss, JAX against the port: both round every activation to bf16,
# their attention rounds P to bf16 for P.V block by block and their silu
# rounds op by op alike, forward and backward, but XLA and PyTorch block
# some bf16 matrix products differently (LOGIT_TOL's reasons).  Measured
# (scripts/grad_gap_cpu.py): up to 1.7e-3 over 4 seeds x 3 batch shapes.
LOSS_TOL = 1e-2
# A gradient leaf, JAX against the port, relative to the leaf's largest
# |value|: the same roundings reach every bf16 gradient, and the
# embedding's scatter-add sums its rows in bf16 in another order.
# Measured (scripts/grad_gap_cpu.py): up to 2.0% (layers/mlp/wg) over 4
# seeds x 3 batch shapes; 2.4% (layers/ln2/scale) while the port's silu
# rounded as F.silu does.
GRAD_RTOL = 0.04
BATCH, SEQ = 4, 16


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(tree):
    """Sorted-key leaves of a JAX tree or the port's as float32 numpy."""
    if isinstance(tree, dict) and tree and not hasattr(
            flatten(tree)[1][0], "detach"):
        return [np.asarray(x, np.float32) for x in flatten(tree)[1]]
    return [f32(x) for x in flatten(tree)[1]]


def assert_leaves_close(want, got, rtol, what, atol=0.0):
    paths = flatten(want)[0]
    for p, a, b in zip(paths, _leaves_np(want), _leaves_np(got)):
        assert a.shape == b.shape, (what, p)
        lim = rtol * float(np.abs(a).max()) + atol
        err = float(np.abs(a - b).max())
        assert err <= lim, f"{what} {p}: max |diff| {err} > {lim}"


def _port_grads(tp, tcfg, batch, knobs):
    paths, pl = flatten(tp)
    ls = [p.detach().requires_grad_() for p in pl]
    loss, _ = lm.loss_fn(unflatten(paths, ls), batch, tcfg, knobs)
    return loss, unflatten(paths, list(torch.autograd.grad(loss, ls)))


def _batch(seed, B=BATCH, S=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S))
    labels = rng.integers(0, 256, (B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_jax(seed, ce_chunk):
    cfg, tcfg, jp, tp = dense_models(seed)
    jb, tb = _batch(seed)
    (jl, jaux), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jb, cfg, None, JModelKnobs(ce_chunk=ce_chunk))
    tl, tg = _port_grads(tp, tcfg, tb, ModelKnobs(ce_chunk=ce_chunk))
    assert abs(float(jl) - float(tl.detach())) <= LOSS_TOL
    assert_leaves_close(_tree_np(jg), tg, GRAD_RTOL, "grad")


def test_ce_chunk_and_remat_give_the_same_gradients():
    """``remat`` none / dots / full and ``ce_chunk`` change what is kept
    for the backward, not the arithmetic: the port's gradients are equal
    bit for bit (the chunked cross entropy sums its chunks in order, so
    it is held within f32 rounding of the whole)."""
    _, tcfg, _, tp = dense_models(3)
    _, tb = _batch(3)
    base_loss, base = _port_grads(tp, tcfg, tb, ModelKnobs())
    for remat in ("dots", "full"):
        loss, g = _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat))
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(flatten(base)[1], flatten(g)[1]):
            assert torch.equal(a, b), remat
    loss, g = _port_grads(tp, tcfg, tb, ModelKnobs(ce_chunk=4))
    assert abs(float(loss) - float(base_loss)) <= 1e-5
    assert_leaves_close(base, g, 1 / 64, "ce_chunk")


def test_remat_recomputes_the_layer_in_the_backward(monkeypatch):
    """Under ``dots`` and ``full`` the attention forward runs again in the
    backward (twice a layer); without remat once."""
    _, tcfg, _, tp = dense_models(0)
    _, tb = _batch(0)
    from repro_torch.models import attention
    calls = []
    real = attention.blocked_attention          # the CPU attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "blocked_attention", counted)
    for remat, want in (("none", 2), ("dots", 4), ("full", 4)):
        calls.clear()
        _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat))
        assert len(calls) == want, remat


def _jax_uniforms(grads, step):
    """The JAX package's int8 draws at ``step``: fold_in(PRNGKey(17),
    step) split per leaf, in sorted-key order."""
    leaves, treedef = jax.tree_util.tree_flatten(grads)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17),
                                               step), len(leaves))
    us = [np.asarray(jax.random.uniform(k, g.shape, jnp.float32))
          for g, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, us)


def _initial_states(seed, tc_kw, staleness):
    cfg, tcfg, jp, _ = dense_models(seed)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    opt_init, _ = j_make_optimizer(jtc)
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    if staleness:
        jstate["grad_queue"] = jax.tree_util.tree_map(
            lambda p: jnp.zeros((staleness,) + p.shape, jnp.bfloat16), jp)
    tstate = train_state_from_numpy(_tree_np(jstate), device="cpu")
    return cfg, tcfg, jtc, ttc, jstate, tstate


STEP_CASES = {
    "default": ({}, {}, 1),
    "microbatches2_f32": ({"microbatches": 2}, {}, 1),
    "microbatches4_f32": ({"microbatches": 4}, {}, 1),
    "microbatches2_bf16": ({"microbatches": 2, "acc_dtype": "bf16"}, {}, 1),
    "microbatches4_bf16": ({"microbatches": 4, "acc_dtype": "bf16"}, {}, 1),
    "staleness1": ({"staleness": 1}, {}, 3),
    "staleness2": ({"staleness": 2}, {}, 4),
    "compression_bf16": ({"compression": "bf16"}, {}, 2),
    "compression_int8": ({"compression": "int8"}, {}, 2),
    "sgd": ({}, {"optimizer": "sgd", "learning_rate": 0.1}, 2),
    "momentum": ({}, {"optimizer": "momentum", "learning_rate": 0.1}, 2),
    "remat_dots_k_chunk256": ({"remat": "dots", "k_chunk": 256}, {}, 1),
    "remat_full": ({"remat": "full"}, {}, 1),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """One setting's steps in both packages from the same state on the
    same batches.  New params within one bf16 step of their size plus, for
    Adam, 2 * lr a step (its first steps move every weight by about lr
    whatever the gradient's size, so a gradient near 0 whose sign differs
    moves it the other way) and, for SGD and momentum, lr times the
    gradient bound a step for each gradient the step applies (every
    |gradient| here is below 1); m, v, mu and the staleness queue within
    the gradient bound of their largest values; count and step
    exactly."""
    knobs, tc_kw, steps = STEP_CASES[case]
    cfg, tcfg, jtc, ttc, jstate, tstate = _initial_states(
        0, tc_kw, knobs.get("staleness", 0))
    jstep = jax.jit(j_build_train_step(cfg, jtc, None, JStepKnobs(**knobs)))
    tstep = build_train_step(tcfg, ttc, StepKnobs(**knobs))
    if knobs.get("compression") == "int8":
        seen = []

        def injected(grads, mode, step, uniforms=None):
            u = _jax_uniforms(train_state_to_numpy(grads), int(step))
            seen.append(int(step))
            return compress_grads(grads, mode, step,
                                  uniforms=train_state_from_numpy(
                                      u, device="cpu"))

        monkeypatch.setattr(stepfn, "compress_grads", injected)
    jb_it = j_batches(cfg, BATCH, SEQ, seed=5)
    tb_it = lm_batch_iterator(tcfg, BATCH, SEQ, seed=5, device="cpu")
    for _ in range(steps):
        jstate, jm = jstep(jstate, next(jb_it))
        tstate, tm = tstep(tstate, next(tb_it))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL
    if knobs.get("compression") == "int8":
        assert seen == list(range(steps))
    want = _tree_np(jstate)
    got = tstate
    lr = ttc.learning_rate
    atol = (2 * lr * steps if ttc.optimizer == "adam"
            else lr * GRAD_RTOL * steps * (steps + 1) / 2)
    assert_leaves_close(want["params"], got["params"], 2 ** -7, "params",
                        atol=atol)
    for k in want["opt"]:
        if k == "count":
            continue
        rtol = 2 * GRAD_RTOL if k == "v" else GRAD_RTOL
        assert_leaves_close(want["opt"][k], got["opt"][k], rtol, f"opt/{k}")
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == steps
    assert got["opt"]["count"].dtype == torch.int32
    assert int(got["step"]) == int(want["step"]) == steps
    if "grad_queue" in want:
        assert_leaves_close(want["grad_queue"], got["grad_queue"],
                            GRAD_RTOL, "grad_queue")
        for a in flatten(got["grad_queue"])[1]:
            assert a.dtype == torch.bfloat16
            assert a.shape[0] == knobs["staleness"]


@pytest.mark.parametrize("optimizer,staleness", [("adam", 0), ("adam", 2),
                                                 ("momentum", 1),
                                                 ("sgd", 0)])
def test_train_state_shapes_match_jax(optimizer, staleness):
    """``train_state_shapes`` (and ``opt_state_shapes`` in it): the same
    leaves, shapes and dtypes as the JAX package's, without allocating;
    and the state ``LMJob.init_state`` allocates has them."""
    from repro_torch.ps.lm_job import LMJob
    cfg, tcfg, _, _ = dense_models(0)
    want = j_train_state_shapes(cfg, JTrainConfig(optimizer=optimizer),
                                knobs=JStepKnobs(staleness=staleness))
    got = train_state_shapes(tcfg, TrainConfig(optimizer=optimizer),
                             knobs=StepKnobs(staleness=staleness))
    wp, wl = flatten(jax.tree_util.tree_map(
        lambda s: (tuple(s.shape), str(s.dtype)), want,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
    gp, gl = flatten(got)
    assert gp == wp
    for (shape, dt), (jshape, jdt) in zip(gl, wl):
        assert shape == jshape and str(dt).split(".")[-1] == jdt
    job = LMJob(tcfg, TrainConfig(optimizer=optimizer), device="cpu")
    state = job.init_state({"staleness": staleness})
    for (shape, dt), t in zip(gl, flatten(state)[1]):
        assert tuple(t.shape) == shape and t.dtype == dt
