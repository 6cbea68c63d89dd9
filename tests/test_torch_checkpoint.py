"""PyTorch port: checkpoints (``checkpoint/ckpt.py``) in the JAX package's
layout, on the CPU: a round trip bit for bit (bf16 included), a JAX-written
checkpoint restored into the port's state and a port-written one into the
JAX package's, retention and a partial write skipped, and a resumed run
whose next loss is the uninterrupted run's, bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as j_restore
from repro.checkpoint import save_pytree as j_save
from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.core.tree import flatten, tree_map
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob

from _torch_port import dense_models


def _jax_state(staleness=0, seed=0):
    cfg, _, jp, _ = dense_models(seed)
    opt_init, _ = j_make_optimizer(JTrainConfig())
    rng = np.random.default_rng(seed)
    opt = opt_init(jp)
    opt = {"m": jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32),
        opt["m"]), "v": opt["v"], "count": jnp.asarray(7, jnp.int32)}
    st = {"params": jp, "opt": opt, "step": jnp.asarray(7, jnp.int32)}
    if staleness:
        st["grad_queue"] = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal((staleness,) + p.shape),
                                  jnp.bfloat16), jp)
    return st


def _zeros_like(state):
    return tree_map(torch.zeros_like, state)


def _assert_equal(a, b):
    pa, la = flatten(a)
    pb, lb = flatten(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


def test_round_trip_bit_for_bit(tmp_path):
    state = train_state_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_state(staleness=2)), device="cpu")
    path = save_pytree(state, str(tmp_path), step=7, extras={"loss": 1.5})
    assert os.path.basename(path) == "step_7"
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    assert meta["paths"] == flatten(state)[0]        # sorted key order
    assert meta["dtypes"][0] == "bfloat16" and meta["extras"]["loss"] == 1.5
    template = _zeros_like(state)
    got, meta = restore_pytree(template, str(tmp_path))
    assert got is template and meta["step"] == 7
    _assert_equal(got, state)
    assert got["step"].shape == () and got["step"].dtype == torch.int32


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_state(staleness=1, seed=1)
    j_save(jstate, str(tmp_path), step=3)
    want = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                  device="cpu")
    got, meta = restore_pytree(_zeros_like(want), str(tmp_path))
    assert meta["step"] == 3
    _assert_equal(got, want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jstate = _jax_state(staleness=2, seed=2)
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   device="cpu")
    save_pytree(state, str(tmp_path), step=11)
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    got, meta = j_restore(template, str(tmp_path))
    assert meta["step"] == 11
    want = train_state_to_numpy(state)
    gl, treedef = jax.tree_util.tree_flatten(got)
    for p, a, b in zip(flatten(want)[0], flatten(want)[1], gl):
        assert b.dtype == jax.tree_util.tree_leaves(jstate)[
            flatten(want)[0].index(p)].dtype, p
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.astype(np.float32), p)


def test_restore_refuses_another_structure_and_a_mesh(tmp_path):
    state = {"a": torch.ones(3), "b": {"c": torch.zeros(2, dtype=torch.int32)}}
    save_pytree(state, str(tmp_path), step=1)
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree({"a": torch.ones(3)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"a": torch.ones(4), "b": {"c": torch.zeros(2)}},
                       str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        restore_pytree(state, str(tmp_path), ms=object())
    with pytest.raises(FileNotFoundError):
        restore_pytree(state, str(tmp_path / "none"))


def test_retention_and_partial_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    state = {"w": torch.arange(4, dtype=torch.bfloat16)}
    saved = [s for s in range(1, 9) if mgr.maybe_save(state, s)]
    assert saved == [2, 4, 6, 8]
    assert sorted(os.listdir(tmp_path)) == ["step_6", "step_8"]
    # a write killed midway leaves only its tmp dir: it is never restored
    os.makedirs(tmp_path / ".tmp_step_10_999")
    assert latest_step(str(tmp_path)) == 8
    got, meta = mgr.restore_latest({"w": torch.zeros(4,
                                                     dtype=torch.bfloat16)})
    assert meta["step"] == 8 and torch.equal(got["w"], state["w"])
    assert latest_step(str(tmp_path / "missing")) is None
    assert CheckpointManager(str(tmp_path), every=0).maybe_save(state, 4) \
        is None


def test_resumed_run_gives_the_next_loss_bit_for_bit(tmp_path):
    """Six steps uninterrupted, saving at step 5; a fresh state (another
    seed) restored from it runs step 6 on the sixth batch: the same loss,
    the same parameters."""
    _, tcfg, _, _ = dense_models(0)
    job = LMJob(tcfg, batch=4, seq=16, device="cpu")
    setting = dict(DEFAULT_LM_SETTING, staleness=1)
    step = job.step_builder(setting)
    state = job.init_state(setting, seed=0)
    mgr = CheckpointManager(str(tmp_path), every=5, keep=1)
    batches = job.batches(0)
    for it in range(1, 7):
        state, m = step(state, next(batches))
        mgr.maybe_save(state, it, {"loss": float(m["loss"])})
    fresh, meta = mgr.restore_latest(job.init_state(setting, seed=1))
    assert meta["step"] == 5 and int(fresh["step"]) == 5
    batches = job.batches(0)
    for _ in range(5):
        next(batches)
    fresh, m2 = step(fresh, next(batches))
    assert float(m2["loss"]) == float(m["loss"])
    _assert_equal(fresh, state)
