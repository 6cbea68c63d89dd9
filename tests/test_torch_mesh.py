"""PyTorch port: the mesh slice held to the JAX package on the CPU.

(a) the specs (``param_specs``, ``state_specs``, ``batch_specs``,
``cache_specs``) of every family's reduced config on seven meshes, the
JAX package's computed over its shape-only ``AbstractMesh``; the rest from
one 4-rank gloo job (``_worker``, started once by the ``mesh_run``
fixture over a FileStore), whose results the tests assert:
(b) ``relocate_now`` 2x2 -> 1x4 -> 4x1, bit for bit; (c) the 2x2 train
step of reduced starcoder2-3b, with and without the int8 push, against the
port's single-device step and the JAX step; (d) ``moe_block_ep`` of
reduced llama4-scout on 1x2 and 2x2 against JAX's per data shard, its
gradients against one process, and both fallbacks; (e) ``transition_step``
against a step and ``relocate_now``; (f) ``LMJob``'s ODMR and baseline
Type I-b plans; (g) the elastic restore from 2x2 onto 2x1, from the JAX
package's layout; (h) ``SelfTuningLoop`` over ``lm_knob_space(4)``: one
plan sequence on every rank, and ``launch/train.py --self-tune`` in the
same world.

The worker is this file run as a script; it imports the port only.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16                      # the train step's batch (global)
MOE_T = (8, 64)                   # decode- and training-sized token counts
# the JAX step's bounds (test_torch_train_step.py): the loss, a gradient-
# like leaf relative to its largest |value|, Adam's 2 * lr a step
LOSS_TOL, GRAD_RTOL = 1e-2, 0.04
# the 2x2 step against the port's single-device step: the data-axis mean
# of two half-batch bf16 gradients rounds where one full-batch product
# rounds once, a bf16 step of the gradient, which Adam's first steps turn
# into up to 2 * lr where a near-zero gradient changes sign
MESH_LOSS_TOL = 2e-3
FAMILIES = {"dense": "starcoder2-3b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-1.2b", "moe": "llama4-scout-17b-a16e",
            "vlm": "phi-3-vision-4.2b", "encoder": "hubert-xlarge"}
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
          "4x2": (4, 2), "2x4": (2, 4), "2x2x2": (2, 2, 2)}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_np(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(_np, tree)


def _digest(tree) -> str:
    from repro_torch.core.tree import flatten
    h = hashlib.sha256()
    for p, x in zip(*flatten(tree)):
        h.update(p.encode())
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


# =====================================================================
# the worker: one rank of the 4-rank gloo job
# =====================================================================

def _whole_state(cfg, tc, seed):
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    params = lm.init_params(cfg, seed, device="cpu")
    return {"params": params, "opt": make_optimizer(tc)[0](params),
            "step": torch.zeros((), dtype=torch.int32)}


def _case_relocate(inp, rank):
    """(b) 2x2 -> 1x4 -> 4x1; the whole state after each move."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.ps.odmr import relocate_now
    from repro_torch.ps.stepfn import state_specs, train_state_shapes
    cfg, tc = get_config("starcoder2-3b").reduced(), TrainConfig()
    shapes = train_state_shapes(cfg, tc)
    state = _whole_state(cfg, tc, 3)
    out, old = {}, (None, None)
    for name in ("2x2", "1x4", "4x1"):
        ms = make_meshspec(*(int(x) for x in name.split("x")))
        specs = state_specs(shapes, ms)
        state = relocate_now(state, specs, ms, *old)
        out[name] = _tree_np(gather_tree(state, specs, ms))
        out[name + "_local"] = tuple(
            state["params"]["layers"]["attn"]["wq"].shape)
        old = (specs, ms)
    return out


def _case_train_step(inp, rank):
    """(c) two 2x2 steps from the JAX parameters, none and int8 (the JAX
    uniforms injected); the whole state and the losses."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.models.convert import (params_to_mesh,
                                            train_state_from_numpy)
    from repro_torch.optim import make_optimizer
    from repro_torch.ps import stepfn
    cfg, tc = get_config("starcoder2-3b").reduced(), TrainConfig()
    ms = make_meshspec(2, 2)
    real = stepfn.compress_grads
    out = {}
    for mode in ("none", "int8"):
        params = params_to_mesh(inp["dense_params"], ms, device="cpu")
        state = {"params": params, "opt": make_optimizer(tc)[0](params),
                 "step": torch.zeros((), dtype=torch.int32)}

        def injected(grads, mode_, step, uniforms=None):
            u = train_state_from_numpy(inp["uniforms"][int(step)], "cpu")
            return real(grads, mode_, step, uniforms=u)

        stepfn.compress_grads = injected if mode == "int8" else real
        try:
            step, shapes, specs = stepfn.jit_train_step(
                cfg, tc, ms, stepfn.StepKnobs(compression=mode))
            it = lm_batch_iterator(cfg, B, S, seed=5, device="cpu")
            losses = []
            for _ in range(2):
                state, m = step(state, next(it))
                losses.append(float(m["loss"]))
        finally:
            stepfn.compress_grads = real
        out[mode] = {"losses": losses,
                     "state": _tree_np(gather_tree(state, specs, ms))}
    return out


def _case_moe(inp, rank):
    """(d) moe_block_ep on 1x2 and 2x2 (each data shard's rows), the
    fallbacks, and the gradients of a loss through EP on 2x2."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_numpy
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    p = params_from_numpy(inp["moe_params"], device="cpu")
    out = {}
    for name in ("1x2", "2x2"):
        dp, tp = (int(x) for x in name.split("x"))
        ms = make_meshspec(dp, tp)
        if ms.coord is None:
            continue
        d = ms.coord["data"]
        for T in MOE_T:
            x = torch.from_numpy(inp["moe_x"][T]).to(torch.bfloat16)
            n = T // dp
            before = dict(moe.DISPATCH)
            o, a = moe.moe_block(x[d * n:(d + 1) * n], p, cfg, ms=ms)
            out[(name, T)] = (_np(o), float(a),
                              moe.DISPATCH["ep"] - before["ep"])
    ms = make_meshspec(2, 2)
    # too few tokens to split over data: the whole batch on every rank
    x1 = torch.from_numpy(inp["moe_x"][8][:1]).to(torch.bfloat16)
    before = dict(moe.DISPATCH)
    o, a = moe.moe_block(x1, p, cfg, ms=dataclasses.replace(ms,
                                                            batch_axes=()))
    out["tokens"] = (_np(o), float(a),
                     moe.DISPATCH["tokens"] - before["tokens"])
    # 3 experts over 2 model ranks: the single group over the gathered
    # tokens
    cfg3 = dataclasses.replace(cfg, n_experts=3)
    p3 = params_from_numpy(inp["moe3_params"], device="cpu")
    x = torch.from_numpy(inp["moe_x"][8]).to(torch.bfloat16)
    d = ms.coord["data"]
    before = dict(moe.DISPATCH)
    o, a = moe.moe_block(x[d * 4:(d + 1) * 4], p3, cfg3, ms=ms)
    out["experts"] = (_np(o), float(a),
                      moe.DISPATCH["experts"] - before["experts"])
    # gradients: loss_d = sum(out_d * w_d) + aux / 2 on each rank, the
    # parameters' gradients averaged over data as the push averages them
    import torch.distributed as dist
    T = MOE_T[1]
    x = torch.from_numpy(inp["moe_x"][T]).to(torch.bfloat16)
    w = torch.from_numpy(inp["moe_w"])
    xl = x[d * T // 2:(d + 1) * T // 2].clone().requires_grad_()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    o, a = moe.moe_block_ep(xl, leaves, cfg, ms)
    loss = (o.float() * w[d * T // 2:(d + 1) * T // 2]).sum() + 0.5 * a
    loss.backward()
    grads = {}
    for k, v in leaves.items():
        g = v.grad.float()
        dist.all_reduce(g, group=ms.data_group)
        grads[k] = (g / 2).numpy()
    out["grads"] = (grads, _np(xl.grad))
    return out


def _case_transition(inp, rank):
    """(e) transition_step 2x2 -> 1x4, and jit_train_step's
    out_state_specs on 2x2 (every leaf whole on every rank), each against
    a 2x2 step, then relocate_now: the largest |difference| of this rank's
    shards."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.ps.odmr import relocate_now, transition_step
    from repro_torch.ps.stepfn import (StepKnobs, build_train_step,
                                       jit_train_step, state_specs,
                                       train_state_shapes)
    cfg, tc = get_config("starcoder2-3b").reduced(), TrainConfig()
    knobs = StepKnobs(staleness=1)
    shapes = train_state_shapes(cfg, tc, knobs=knobs)
    old, new = make_meshspec(2, 2), make_meshspec(1, 4)
    so, sn = state_specs(shapes, old), state_specs(shapes, new)

    def placed():
        s = _whole_state(cfg, tc, 4)
        s["grad_queue"] = {k: v for k, v in _queue(s["params"]).items()}
        return relocate_now(s, so, old)

    def compare(a, b):
        fa, fb = flatten(a), flatten(b)
        return {"paths_equal": fa[0] == fb[0],
                "max_diff": max(float((x.float() - y.float()).abs().max())
                                for x, y in zip(fa[1], fb[1])),
                "shapes_equal": all(x.shape == y.shape
                                    for x, y in zip(fa[1], fb[1]))}

    batch = next(lm_batch_iterator(cfg, B, S, seed=6, device="cpu"))
    a, _ = transition_step(cfg, tc, old, new, knobs)(placed(), batch)
    b, _ = build_train_step(cfg, tc, knobs, ms=old)(placed(), batch)
    out = {"1x4": compare(a, relocate_now(b, sn, new, so, old))}
    whole = tree_map(lambda spec: (None,) * len(spec), so)
    step, _, specs = jit_train_step(cfg, tc, old, knobs,
                                    out_state_specs=whole)
    assert specs == so
    a, _ = step(placed(), batch)
    b, _ = build_train_step(cfg, tc, knobs, ms=old)(placed(), batch)
    out["whole"] = compare(a, relocate_now(b, whole, old, so, old))
    out["whole_shape"] = tuple(a["opt"]["m"]["layers"]["attn"]["wq"].shape)
    return out


def _queue(params):
    from repro_torch.core.tree import tree_map
    g = torch.Generator().manual_seed(9)
    return tree_map(lambda p: torch.randn((1,) + tuple(p.shape),
                                          generator=g).to(torch.bfloat16),
                    params)


def _job(batch=B, seq=S):
    from repro_torch.configs.registry import get_config
    from repro_torch.ps.lm_job import LMJob
    return LMJob(get_config("starcoder2-3b").reduced(), batch=batch,
                 seq=seq, device="cpu")


def _case_adapter(inp, rank):
    """(f) ODMR and baseline I-b plans (2x2, staleness 1 -> 1x4,
    staleness 2) on one trained state: their shards, and the whole state
    before and after."""
    from repro_torch.core import reconfig
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING
    job = _job()
    s_old = dict(DEFAULT_LM_SETTING, mesh_split="2x2", staleness=1)
    s_new = dict(DEFAULT_LM_SETTING, mesh_split="1x4", staleness=2)
    state = job.init_state(s_old, seed=2)
    state, _ = job.step_builder(s_old)(state, next(job.batches(0)))
    before = _tree_np(gather_tree(state, job.specs(s_old),
                                  job.meshspec(s_old)))
    copy = tree_map(torch.clone, state)
    a = job.state_adapter(state, reconfig.plan(s_old, s_new, True))
    b = job.state_adapter(copy, reconfig.plan(s_old, s_new, False))
    after = _tree_np(gather_tree(a, job.specs(s_new), job.meshspec(s_new)))
    fa, fb = flatten(a), flatten(b)
    return {"same": fa[0] == fb[0] and all(
        torch.equal(x, y) for x, y in zip(fa[1], fb[1])),
        "before": before, "after": after}


def _case_restore(inp, rank):
    """(g) a 2x2 state saved (the mesh's first rank writes), restored onto
    2x1 (ranks 0 and 1): the whole state saved and restored."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING
    job = _job()
    s22 = dict(DEFAULT_LM_SETTING, mesh_split="2x2")
    s21 = dict(DEFAULT_LM_SETTING, mesh_split="2x1")
    state = job.init_state(s22, seed=5)
    state, _ = job.step_builder(s22)(state, next(job.batches(1)))
    saved = _tree_np(gather_tree(state, job.specs(s22), job.meshspec(s22)))
    save_pytree(state, inp["dir"] + "/ckpt", step=1,
                ms=job.meshspec(s22), specs=job.specs(s22))
    ms = job.meshspec(s21)
    out = {"saved": saved}
    if ms.coord is not None:
        state, meta = restore_pytree(job.empty_state(s21), inp["dir"] + "/ckpt",
                                     ms=ms)
        out["local"] = tuple(state["params"]["layers"]["attn"]["wq"].shape)
        out["restored"] = _tree_np(gather_tree(state, job.specs(s21), ms))
        out["step"] = meta["step"]
    return out


def _case_selftune(inp, rank):
    """(h) SelfTuningLoop over lm_knob_space(4): the plans every rank
    applied and a digest of its whole final state."""
    from repro_torch.core.tuner import TunerConfig, TuningManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, lm_knob_space
    from repro_torch.ps.trainer import SelfTuningLoop
    job = _job(batch=8, seq=8)
    x0 = dict(DEFAULT_LM_SETTING, mesh_split="4x1")
    tuner = TuningManager(lm_knob_space(4), x0,
                          TunerConfig(eps=0.05, a=2, b=3, seed=1))
    plans = []

    def adapter(state, plan):
        plans.append((plan.kinds, plan.method, sorted(plan.new.items())))
        return job.state_adapter(state, plan)

    state = job.init_state(x0, seed=0)
    loop = SelfTuningLoop(tuner, job.step_builder, adapter)
    res, state = loop.run(state, job.batches(0), max_iters=7)
    ms, specs = job.placement()
    return {"plans": plans, "iterations": res.iterations,
            "digest": _digest(_tree_np(gather_tree(state, specs, ms)))}


def _case_launcher(inp, rank):
    """The training launcher in the running 4-rank world: --self-tune (the
    mesh_split knob among the rest) with a sharded checkpoint every 3
    steps; what each rank printed."""
    import contextlib
    import io

    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
                    "--self-tune", "--steps", "7", "--tuner-a", "2",
                    "--tuner-b", "3", "--batch", "8", "--seq", "8",
                    "--ckpt-dir", inp["dir"] + "/launch_ckpt",
                    "--ckpt-every", "3"])
    return {"out": buf.getvalue()}


CASES = {"relocate": _case_relocate, "train_step": _case_train_step,
         "moe": _case_moe, "transition": _case_transition,
         "adapter": _case_adapter, "restore": _case_restore,
         "selftune": _case_selftune, "launcher": _case_launcher}


def _worker(rank: int, d: str):
    import traceback

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    torch.manual_seed(0)
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{d}/store", rank, WORLD,
                     timeout=datetime.timedelta(seconds=60))
    with open(f"{d}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}
    for name, fn in CASES.items():
        t0 = time.perf_counter()
        try:
            out[name] = fn(inp, rank)
        except Exception:                 # reported to the test, per case
            out[name] = {"error": traceback.format_exc()}
        out[name + "_s"] = time.perf_counter() - t0
        with open(f"{d}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        if "error" in out[name]:
            # the other ranks may wait in a collective of this case: end
            # this process so that theirs fail at once
            os._exit(1)
        dist.barrier()
    dist.destroy_process_group()


# =====================================================================
# the parent: inputs, the JAX references, the job
# =====================================================================

def _port_params(arch, **kw):
    """Reduced ``arch``'s parameters from the port's seeded init, as numpy
    (bf16 leaves as ml_dtypes' bfloat16, as the JAX package holds
    them)."""
    import ml_dtypes

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    return tree_map(lambda t: (t.float().numpy().astype(ml_dtypes.bfloat16)
                               if t.dtype == torch.bfloat16 else t.numpy()),
                    lm.init_params(cfg, 0, device="cpu"))


def _jax_uniforms(tree, steps):
    """The JAX package's int8 draws at each step: fold_in(PRNGKey(17),
    step) split per leaf, in sorted-key order (under jit, as its step
    draws them)."""
    import jax
    import jax.numpy as jnp
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    shapes = [x.shape for x in leaves]

    @jax.jit
    def draw(step):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17),
                                                   step), len(shapes))
        return [jax.random.uniform(k, sh, jnp.float32)
                for k, sh in zip(keys, shapes)]

    return {s: jax.tree_util.tree_unflatten(
        treedef, [np.asarray(u) for u in draw(s)]) for s in steps}


def _step_refs(inp):
    """(c)'s references: two steps of the port's single-device step and of
    the JAX step on the same parameters, batches and int8 uniforms."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.configs.registry import get_config as jget_config
    from repro.data.synthetic import lm_batch_iterator as j_batches
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.ps.stepfn import StepKnobs as JStepKnobs
    from repro.ps.stepfn import build_train_step as j_build_train_step
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.models.convert import (params_from_numpy,
                                            train_state_from_numpy)
    from repro_torch.optim import make_optimizer
    from repro_torch.ps import stepfn
    cfg = get_config("starcoder2-3b").reduced()
    jcfg = jget_config("starcoder2-3b").reduced()
    tc, jtc = TrainConfig(), JTrainConfig()
    out = {}
    real = stepfn.compress_grads
    for mode in ("none", "int8"):
        params = params_from_numpy(inp["dense_params"], device="cpu")
        state = {"params": params, "opt": make_optimizer(tc)[0](params),
                 "step": torch.zeros((), dtype=torch.int32)}

        def injected(grads, mode_, step, uniforms=None):
            u = train_state_from_numpy(inp["uniforms"][int(step)], "cpu")
            return real(grads, mode_, step, uniforms=u)

        stepfn.compress_grads = injected if mode == "int8" else real
        try:
            step = stepfn.build_train_step(cfg, tc,
                                           stepfn.StepKnobs(compression=mode))
            it = lm_batch_iterator(cfg, B, S, seed=5, device="cpu")
            losses = []
            for _ in range(2):
                state, m = step(state, next(it))
                losses.append(float(m["loss"]))
        finally:
            stepfn.compress_grads = real
        jp = jax.tree_util.tree_map(jnp.asarray, inp["dense_params"])
        js = {"params": jp, "opt": j_make_optimizer(jtc)[0](jp),
              "step": jnp.zeros((), jnp.int32)}
        jstep = jax.jit(j_build_train_step(jcfg, jtc, None,
                                           JStepKnobs(compression=mode)))
        jit = j_batches(jcfg, B, S, seed=5)
        jl = []
        for _ in range(2):
            js, jm = jstep(js, next(jit))
            jl.append(float(jm["loss"]))
        out[mode] = {"port": (losses, _tree_np(state)),
                     "jax": (jl, jax.tree_util.tree_map(np.asarray, js))}
    return out


def _moe_refs(inp):
    """(d)'s JAX references: ``moe_block_ep`` on one device over each data
    shard (1x2: one shard, 2x2: two), and ``moe_block`` on the fallbacks'
    global tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jget_config
    from repro.distributed.sharding import single_device_meshspec
    from repro.models import moe as jmoe
    cfg = jget_config("llama4-scout-17b-a16e").reduced()
    cfg3 = jget_config("llama4-scout-17b-a16e").reduced(n_experts=3)
    p = {k: jnp.asarray(v) for k, v in inp["moe_params"].items()}
    p3 = {k: jnp.asarray(v) for k, v in inp["moe3_params"].items()}
    ep = jax.jit(lambda x: jmoe.moe_block_ep(x, p, cfg,
                                             single_device_meshspec()))
    out = {}
    for dp in (1, 2):
        for T in MOE_T:
            x = jnp.asarray(inp["moe_x"][T], jnp.bfloat16)
            n = T // dp
            outs, auxs = zip(*(ep(x[d * n:(d + 1) * n]) for d in range(dp)))
            out[(dp, T)] = (
                np.concatenate([np.asarray(o, np.float32) for o in outs]),
                float(np.mean([float(a) for a in auxs])))
    x = jnp.asarray(inp["moe_x"][8], jnp.bfloat16)
    for key, c, pp, xs in (("tokens", cfg, p, x[:1]),
                           ("experts", cfg3, p3, x)):
        o, a = jax.jit(lambda x_: jmoe.moe_block(x_, pp, c))(xs)
        out[key] = (np.asarray(o, np.float32), float(a))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 4-rank job's results, and the references computed here while
    it runs."""
    d = tmp_path_factory.mktemp("mesh")
    dense = _port_params("starcoder2-3b")
    moe = _port_params("llama4-scout-17b-a16e")["layers"]["moe"]
    moe3 = _port_params("llama4-scout-17b-a16e",
                        n_experts=3)["layers"]["moe"]
    rng = np.random.default_rng(11)
    D = moe["router"].shape[1]
    inp = {"dir": str(d), "dense_params": dense,
           "uniforms": _jax_uniforms(dense, (0, 1)),
           "moe_params": {k: v[0] for k, v in moe.items()},
           "moe3_params": {k: v[0] for k, v in moe3.items()},
           # bf16-exact tokens: both packages round them to bf16 alike
           "moe_x": {T: np.asarray(torch.randn(
               (T, D), generator=torch.Generator().manual_seed(T)).to(
               torch.bfloat16).float()) for T in MOE_T},
           "moe_w": rng.standard_normal((MOE_T[1], D)).astype(np.float32)}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    logs = [open(d / f"log{r}", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(d)], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        refs = {"step": _step_refs(inp), "moe": _moe_refs(inp)}
        for p in procs:
            p.wait(timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        text = []
        for f in logs:
            f.seek(0)
            text.append(f.read())
            f.close()
    out = []
    for r in range(WORLD):
        try:
            with open(d / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        except FileNotFoundError:
            out.append({})
    return {"inputs": inp, "ranks": out, "logs": text, "refs": refs,
            "seconds": time.perf_counter() - t0}


def _ok(run, case):
    """Every rank's result of ``case``; its error, or the rank's log where
    the rank never reached it."""
    res = []
    for r, ranks in enumerate(run["ranks"]):
        assert case in ranks, f"rank {r}:\n{run['logs'][r][-4000:]}"
        assert "error" not in ranks[case], \
            f"rank {r}: {ranks[case]['error']}"
        res.append(ranks[case])
    return res


def assert_leaves_close(want, got, rtol, what, atol=0.0):
    from repro_torch.core.tree import flatten
    paths = flatten(want)[0]
    for p, a, b in zip(paths, flatten(want)[1], flatten(got)[1]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, p)
        lim = rtol * float(np.abs(a).max()) + atol
        err = float(np.abs(a - b).max())
        assert err <= lim, f"{what} {p}: max |diff| {err} > {lim}"


def assert_same(want, got, what):
    from repro_torch.core.tree import flatten
    pw, lw = flatten(want)
    pg, lg = flatten(got)
    assert pw == pg, what
    for p, a, b in zip(pw, lw, lg):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what} {p}"


# =====================================================================
# (a) spec parity, shape only
# =====================================================================

def _meshspecs(shape):
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.distributed.sharding import MeshSpec as JMeshSpec
    from repro_torch.distributed.sharding import AbstractMesh, MeshSpec
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    data = names[:-1]
    return (JMeshSpec(mesh=JAbstractMesh(shape, names), data_axes=data),
            MeshSpec(mesh=AbstractMesh(shape, names), data_axes=data))


def _same_specs(jtree, ttree, what):
    import jax
    from jax.sharding import PartitionSpec

    from repro_torch.core.tree import flatten
    jl = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    paths, tl = flatten(ttree)
    assert len(jl) == len(tl), what
    for (jp, js), p, ts in zip(jl, paths, tl):
        jpath = "/".join(str(getattr(k, "key", k)) for k in jp)
        assert jpath == p and tuple(js) == ts, (what, p, tuple(js), ts)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_specs_match_jax(family, mesh):
    """param_specs, state_specs (staleness 0 and 2), batch_specs (batches
    that divide the data axes, only their inner axis, and neither) and
    cache_specs equal the JAX package's, entry for entry."""
    import jax

    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.configs.registry import get_config as jget_config
    from repro.distributed.sharding import param_specs as jparam_specs
    from repro.models import lm as jlm
    from repro.ps import stepfn as jstepfn
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.models import lm
    from repro_torch.ps import stepfn
    arch = FAMILIES[family]
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jms, ms = _meshspecs(MESHES[mesh])
    _same_specs(jparam_specs(jlm.param_shapes(jcfg), jms),
                param_specs(lm.param_shapes(cfg), ms), "params")
    for s in (0, 2):
        jsh = jstepfn.train_state_shapes(
            jcfg, JTrainConfig(), knobs=jstepfn.StepKnobs(staleness=s))
        tsh = stepfn.train_state_shapes(
            cfg, TrainConfig(), knobs=stepfn.StepKnobs(staleness=s))
        _same_specs(jstepfn.state_specs(jsh, jms),
                    stepfn.state_specs(tsh, ms), f"state s={s}")
    for b in (8, 2, 3):
        shapes = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                  "labels": jax.ShapeDtypeStruct((b, 16), np.int32),
                  "frontend": jax.ShapeDtypeStruct((b, 4, 32), np.float32),
                  "valid": jax.ShapeDtypeStruct((), np.int32)}
        _same_specs(jstepfn.batch_specs(shapes, jms),
                    stepfn.batch_specs(shapes, ms), f"batch {b}")
    for b in (4, 2, 1):
        cache = jlm.init_cache_shapes(jcfg, b, 32)
        _same_specs(jstepfn.cache_specs(cache, jms),
                    stepfn.cache_specs(cache, ms), f"cache {b}")
    from repro.distributed.sharding import batch_pspec as jbatch_pspec
    from repro.distributed.sharding import constrain as jconstrain
    from repro.ps.odmr import reshard_specs as jreshard
    from repro_torch.distributed.sharding import batch_pspec, constrain
    from repro_torch.ps.odmr import reshard_specs
    _same_specs(jreshard(jlm.param_shapes(jcfg), jms),
                reshard_specs(lm.param_shapes(cfg), ms), "reshard")
    for nd in (1, 2, 3):
        assert tuple(jbatch_pspec(jms, nd)) == batch_pspec(ms, nd)
    x = torch.zeros((4, 6))
    assert constrain(x, ms, "D", "M") is x
    if ms.n_devices == 1:
        assert jconstrain(x, jms, "D", "M") is x


@pytest.mark.parametrize("n", [1, 4, 8, 256])
def test_default_ps_knob_space_matches_jax(n):
    from repro.core.knobs import default_ps_knob_space as jspace
    from repro_torch.core.knobs import default_ps_knob_space
    for mesh in (True, False):
        j, t = jspace(n, mesh), default_ps_knob_space(n, mesh)
        assert [(k.name, k.kind, k.values) for k in j.knobs] == \
            [(k.name, k.kind, k.values) for k in t.knobs]


def test_production_meshes_are_shape_only_without_a_world():
    from repro.distributed.sharding import param_specs as jparam_specs
    from repro.models import lm as jlm
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.mesh import make_meshspec, production_meshspec
    from repro_torch.models import lm
    from repro.configs.registry import get_config as jget_config
    from repro_torch.configs.registry import get_config
    for pods in (False, True):
        ms = production_meshspec(multi_pod=pods)
        assert ms.n_devices == (512 if pods else 256) and not ms.live
        _same_specs(jparam_specs(jlm.param_shapes(
            jget_config("starcoder2-3b")), _meshspecs(
            (2, 16, 16) if pods else (16, 16))[0]),
            param_specs(lm.param_shapes(get_config("starcoder2-3b")), ms),
            "production")
        with pytest.raises(ValueError, match="ranks"):
            production_meshspec(multi_pod=pods, live=True)
    with pytest.raises(ValueError, match="ranks"):
        make_meshspec(2, 2)


# =====================================================================
# (b)-(h) the 4-rank job
# =====================================================================

def test_relocation_keeps_every_bit(mesh_run):
    """(b) 2x2 -> 1x4 -> 4x1: every leaf's whole tensor the same bits as
    the state placed, on every rank, and each rank's shard the spec's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    res = _ok(mesh_run, "relocate")
    want = _tree_np(_whole_state(get_config("starcoder2-3b").reduced(),
                                 TrainConfig(), 3))
    for r, out in enumerate(res):
        for name in ("2x2", "1x4", "4x1"):
            assert_same(want, out[name], f"rank {r} {name}")
    D = want["params"]["layers"]["attn"]["wq"].shape
    assert res[0]["2x2_local"] == (D[0], D[1] // 2, D[2] // 2)
    assert res[0]["1x4_local"] == (D[0], D[1], D[2] // 4)
    assert res[0]["4x1_local"] == (D[0], D[1] // 4, D[2])


def _hold_state(want, got, what):
    from repro_torch.configs.base import TrainConfig
    lr = 2 * TrainConfig().learning_rate * 2     # 2 * lr a step, two steps
    assert_leaves_close(want["params"], got["params"], 2 ** -7,
                        f"{what} params", atol=lr)
    for k in ("m", "v"):
        rtol = 2 * GRAD_RTOL if k == "v" else GRAD_RTOL
        assert_leaves_close(want["opt"][k], got["opt"][k], rtol,
                            f"{what} opt/{k}")
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 2
    assert int(got["step"]) == int(want["step"]) == 2


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_mesh_train_step_matches_single_device_and_jax(mesh_run, mode):
    """(c) two 2x2 steps: the loss within 2e-3 of the port's single-device
    step (and every rank's the same), the state within the JAX bounds of
    test_torch_train_step.py of both the port's single-device state and
    the JAX state."""
    res = _ok(mesh_run, "train_step")
    losses, want = mesh_run["refs"]["step"][mode]["port"]
    jlosses, jstate = mesh_run["refs"]["step"][mode]["jax"]
    for r in res:
        assert r[mode]["losses"] == res[0][mode]["losses"]
    got = res[0][mode]
    for a, b, c in zip(got["losses"], losses, jlosses):
        assert abs(a - b) <= MESH_LOSS_TOL and abs(a - c) <= LOSS_TOL
    _hold_state(want, got["state"], "port")
    _hold_state(jstate, got["state"], "jax")
    for r in res[1:]:
        assert_same(got["state"], r[mode]["state"], "ranks")


def _bf16_steps(ref):
    a = np.maximum(np.abs(ref), np.abs(ref).max() * 2.0 ** -8)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_moe_block_ep_matches_jax_per_data_shard(mesh_run):
    """(d) moe_block_ep on 1x2 and 2x2 at T = 8 and 64: each data shard's
    rows within one bf16 step of JAX's moe_block_ep on one device over
    that shard, aux within 1e-6 of the shards' mean; EP taken each time;
    ranks 2 and 3 are outside the 1x2 mesh."""
    res = _ok(mesh_run, "moe")
    for name, (dp, tp) in (("1x2", (1, 2)), ("2x2", (2, 2))):
        for T in MOE_T:
            want, aux = mesh_run["refs"]["moe"][(dp, T)]
            n = T // dp
            for r in range(dp * tp):
                o, a, ep = res[r][(name, T)]
                d = r // tp
                w = want[d * n:(d + 1) * n]
                assert ep == 1
                assert np.all(np.abs(o - w) <= _bf16_steps(w)), (name, T, r)
                assert abs(a - aux) <= 1e-6, (name, T, r)
            for r in range(dp * tp, WORLD):
                assert (name, T) not in res[r]


def test_moe_fallbacks_take_the_single_group(mesh_run):
    """(d) T = 1 over dp = 2 (too few tokens) and 3 experts over tp = 2
    (E % tp) take the single-group path over the global tokens, as JAX's
    ``moe_block`` does, and are counted."""
    res = _ok(mesh_run, "moe")
    for key in ("tokens", "experts"):
        want, aux = mesh_run["refs"]["moe"][key]
        for r in range(WORLD):
            o, a, hits = res[r][key]
            rows = want if key == "tokens" else want[(r // 2) * 4:
                                                     (r // 2 + 1) * 4]
            assert hits == 1, key
            assert np.all(np.abs(o - rows) <= _bf16_steps(rows)), (key, r)
            assert abs(a - aux) <= 1e-6, key


def test_moe_block_ep_gradients_match_one_process(mesh_run):
    """(d) The gradients of sum(out * w) + aux / 2 through EP on 2x2: the
    experts' and router's, averaged over data as the push averages them,
    and each rank's token rows, against one process running each data
    shard as its own group (the port's EP at one device), within one bf16
    step (the ranks' partial outputs are summed over the model axis)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import single_device_meshspec
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_numpy
    res = _ok(mesh_run, "moe")
    inp = mesh_run["inputs"]
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    p = {k: v.requires_grad_() for k, v in
         params_from_numpy(inp["moe_params"], device="cpu").items()}
    T = MOE_T[1]
    x = torch.from_numpy(inp["moe_x"][T]).to(torch.bfloat16)
    xs = [x[:T // 2].clone().requires_grad_(),
          x[T // 2:].clone().requires_grad_()]
    w = torch.from_numpy(inp["moe_w"])
    sd = single_device_meshspec()
    outs = [moe.moe_block_ep(xd, p, cfg, sd) for xd in xs]
    loss = sum((o.float() * w[d * T // 2:(d + 1) * T // 2]).sum()
               for d, (o, _) in enumerate(outs)) / 2 \
        + 0.5 * torch.stack([a for _, a in outs]).mean()
    loss.backward()
    for r in range(WORLD):
        grads, gx = res[r]["grads"]
        for k, v in p.items():
            want = v.grad.float().numpy()
            assert np.abs(grads[k] - want).max() <= \
                2 ** -7 * np.abs(want).max(), (r, k)
        want = 2 * xs[r // 2].grad.float().numpy()
        assert np.all(np.abs(gx - want) <= _bf16_steps(want)), r


def test_transition_step_is_a_step_then_relocation(mesh_run):
    """(e) 2x2 -> 1x4 with a staleness queue, and the out_state_specs hook
    (every leaf whole): the same shards, bit for bit, on every rank."""
    for r, out in enumerate(_ok(mesh_run, "transition")):
        for case in ("1x4", "whole"):
            c = out[case]
            assert c["paths_equal"] and c["shapes_equal"], (r, case)
            assert c["max_diff"] == 0.0, (r, case, c["max_diff"])
        assert out["whole_shape"] == (2, 64, 64)


def test_odmr_and_baseline_plans_give_one_state(mesh_run):
    """(f) LMJob.state_adapter: the ODMR and checkpoint-baseline I-b plans
    (with a staleness change) give equal shards on every rank, and the
    whole state keeps its values, the queue resized as the staleness
    adapter resizes it."""
    res = _ok(mesh_run, "adapter")
    for r, out in enumerate(res):
        assert out["same"], r
        before, after = out["before"], out["after"]
        assert_same({k: before[k] for k in ("params", "opt", "step")},
                    {k: after[k] for k in ("params", "opt", "step")}, r)
        for a, b in zip(*(_leaves(t["grad_queue"]) for t in (before,
                                                              after))):
            assert b.shape[0] == 2 and np.array_equal(a[-1], b[-1])
            assert not b[0].any()


def _leaves(tree):
    from repro_torch.core.tree import flatten
    return flatten(tree)[1]


def test_elastic_restore_onto_a_smaller_mesh(mesh_run):
    """(g) Saved on 2x2 (the JAX package's layout: its restore_pytree reads
    it), restored onto 2x1: every value as saved, each rank its 2x1
    shard."""
    import jax

    from repro.checkpoint import restore_pytree as jrestore
    res = _ok(mesh_run, "restore")
    saved = res[0]["saved"]
    for r in range(2):
        assert res[r]["step"] == 1
        assert_same(saved, res[r]["restored"], f"rank {r}")
    D = saved["params"]["layers"]["attn"]["wq"].shape
    assert res[0]["local"] == (D[0], D[1] // 2, D[2])
    assert "restored" not in res[2] and "restored" not in res[3]
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), saved)
    got, meta = jrestore(template,
                         mesh_run["inputs"]["dir"] + "/ckpt", step=1)
    assert meta["step"] == 1
    assert_same(saved, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32 if a.dtype == jax.numpy.bfloat16
                             else a.dtype), got), "jax restore")


def test_self_tuning_loop_applies_one_plan_sequence(mesh_run):
    """(h) Four ranks, one tuner on rank 0: every rank applies the same
    plans at the same iterations (a mesh_split among them) and ends with
    the same whole state."""
    res = _ok(mesh_run, "selftune")
    assert all(r["plans"] == res[0]["plans"] for r in res)
    assert all(r["digest"] == res[0]["digest"] for r in res)
    assert all(r["iterations"] == res[0]["iterations"] == 7 for r in res)
    assert any("I-b" in kinds for kinds, _, _ in res[0]["plans"])


def test_launcher_under_four_ranks(mesh_run):
    """``launch/train.py --self-tune`` in a 4-rank world: rank 0 alone
    prints, applies at least one mesh_split (Type I-b) plan and ends in
    OK; its sharded checkpoints hold the whole parameters, in the JAX
    package's layout."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import flatten
    from repro_torch.models import lm
    res = _ok(mesh_run, "launcher")
    out = res[0]["out"]
    assert "ranks=4" in out and out.rstrip().endswith("OK"), out
    assert any(line.startswith("[reconfig@") and "'I-b'" in line
               for line in out.splitlines()), out
    assert all(r["out"] == "" for r in res[1:])
    d = mesh_run["inputs"]["dir"] + "/launch_ckpt"
    assert latest_step(d) == 6
    with np.load(f"{d}/step_6/arrays.npz") as z, \
            open(f"{d}/step_6/meta.json") as f:
        paths = json.load(f)["paths"]
        shapes = dict(zip(*flatten(lm.param_shapes(
            get_config("starcoder2-3b").reduced()))))
        for i, p in enumerate(paths):
            if p.startswith("params/"):
                assert z[f"a{i}"].shape == tuple(shapes[p[7:]]), p


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
