"""PyTorch port: the self-tuning training loop held to the JAX package on
the CPU (reduced starcoder2-3b).

``lm_batch_iterator``'s tokens equal the JAX package's exactly; the
staleness adapter's queue surgery (grow, shrink, to and from 0) equals
JAX's on the same state; both packages' ``SelfTuningLoop`` under one stub
tuner that issues the same plans at the same iterations give the same loss
curve (within the loss bound of ``test_torch_train_step.py``); and the real
``TuningManager`` drives the port's loop to its ``max_iters``, as
``tests/test_tuner_integration.py::test_selftuning_loop_on_logr`` drives
the JAX package's."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reconfig as jrc
from repro.data.synthetic import lm_batch_iterator as j_batches
from repro.ps.lm_job import LMJob as JLMJob
from repro.ps.trainer import SelfTuningLoop as JLoop
from repro.ps.trainer import make_staleness_adapter as j_adapter
from repro_torch.core import reconfig as trc
from repro_torch.core.tree import flatten
from repro_torch.core.tuner import TunerConfig, TuningManager
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.ps.lm_job import (DEFAULT_LM_SETTING, LMJob, lm_knob_space,
                                   setting_to_stepknobs)
from repro_torch.ps.trainer import LoopResult, SelfTuningLoop
from repro_torch.ps.trainer import make_staleness_adapter as t_adapter

from _torch_port import dense_models

# the per-step loss bound of the train-step parity (test_torch_train_step)
LOSS_TOL = 1e-2


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("batch,seq,seed", [(4, 16, 0), (2, 33, 7),
                                            (8, 128, 3)])
def test_batches_equal_jax(batch, seq, seed):
    cfg, tcfg, _, _ = dense_models(0)
    jit = j_batches(cfg, batch, seq, seed)
    tit = lm_batch_iterator(tcfg, batch, seq, seed, device="cpu")
    for _ in range(4):
        jb, tb = next(jit), next(tit)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int64 and tb[k].shape == (batch, seq)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_batches_need_a_device_unless_cpu_is_asked(monkeypatch):
    _, tcfg, _, _ = dense_models(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(lm_batch_iterator(tcfg, 2, 8, 0))


def _queue_state(old_s, seed=0):
    cfg, _, jp, _ = dense_models(seed)
    rng = np.random.default_rng(seed)
    state = {"params": jp, "step": jnp.asarray(5, jnp.int32)}
    if old_s:
        state["grad_queue"] = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal((old_s,) + p.shape),
                                  jnp.bfloat16), jp)
    return state


@pytest.mark.parametrize("old_s,new_s", [(1, 2), (2, 1), (2, 0), (0, 2),
                                         (1, 1)])
def test_staleness_surgery_equals_jax(old_s, new_s):
    jstate = _queue_state(old_s)
    tstate = train_state_from_numpy(_tree_np(jstate), device="cpu")
    old = dict(DEFAULT_LM_SETTING, staleness=old_s)
    new = dict(DEFAULT_LM_SETTING, staleness=new_s)
    want = j_adapter(jnp.bfloat16)(jstate, jrc.plan(old, new))
    got = t_adapter(torch.bfloat16)(tstate, trc.plan(old, new))
    assert ("grad_queue" in got) == ("grad_queue" in want) == (new_s > 0)
    if new_s:
        w, g = _tree_np(want["grad_queue"]), got["grad_queue"]
        for p, a, b in zip(flatten(w)[0], flatten(w)[1], flatten(g)[1]):
            assert b.dtype == torch.bfloat16 and b.shape[0] == new_s, p
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32), p)
    assert got["params"] is tstate["params"]


class StubTuner:
    """The tuner interface the loop drives, issuing fixed plans: after
    iteration i (1-based) it proposes ``plans_at[i]``.  ``rc`` is the
    package's reconfig module (each loop gets its own package's plans)."""

    def __init__(self, x0, plans_at, rc):
        self.current = dict(x0)
        self.plans_at = plans_at
        self.rc = rc
        self.converged = False
        self.history = []
        self.losses = []
        self.costs = []
        self.repo = SimpleNamespace(latest_loss=None)
        self._iter = 0

    def record_iteration(self, loss, time_s):
        self._iter += 1
        self.losses.append(loss)
        self.repo.latest_loss = loss

    def maybe_advance(self):
        new = self.plans_at.get(self._iter)
        return None if new is None else self.rc.plan(self.current, new)

    def record_reconfig(self, plan, cost_s):
        self.current = dict(plan.new)
        self.costs.append(cost_s)


PLANS = {3: dict(DEFAULT_LM_SETTING, staleness=2, microbatches=2),
         6: dict(DEFAULT_LM_SETTING, staleness=1, remat="dots",
                 k_chunk=256),
         9: dict(DEFAULT_LM_SETTING, staleness=0, compression="bf16",
                 remat="full")}


def test_loops_under_one_stub_tuner_give_the_same_loss_curve():
    """Both loops from the same state and batches, the same plans at the
    same iterations (staleness grown, shrunk and dropped; microbatches,
    remat, k_chunk and bf16 compression switched): the loss curves agree
    step by step, every plan runs, and each loop reports its result."""
    cfg, tcfg, _, _ = dense_models(0)
    jjob = JLMJob(cfg, batch=4, seq=16, seed=0)
    tjob = LMJob(tcfg, batch=4, seq=16, seed=0, device="cpu")
    jstate = jjob.init_state(DEFAULT_LM_SETTING, seed=0)
    tstate = train_state_from_numpy(_tree_np(jstate), device="cpu")
    jt = StubTuner(DEFAULT_LM_SETTING, PLANS, jrc)
    tt = StubTuner(DEFAULT_LM_SETTING, PLANS, trc)
    jres, jstate = JLoop(jt, jjob.step_builder, jjob.state_adapter).run(
        jstate, jjob.batches(0), max_iters=12)
    tres, tstate = SelfTuningLoop(tt, tjob.step_builder,
                                  tjob.state_adapter).run(
        tstate, tjob.batches(0), max_iters=12)
    assert isinstance(tres, LoopResult)
    assert tres.iterations == jres.iterations == 12
    assert len(tt.costs) == len(jt.costs) == 3 and tt.current == PLANS[9]
    assert tres.reconfig_total_s == pytest.approx(sum(tt.costs))
    np.testing.assert_allclose(tt.losses, jt.losses, atol=LOSS_TOL, rtol=0)
    assert "grad_queue" not in tstate
    assert int(tstate["step"]) == int(jstate["step"]) == 12
    assert train_state_to_numpy(tstate)["opt"]["count"] == 12


def test_real_tuner_drives_the_port_loop():
    """The TuningManager over ``lm_knob_space(1)`` drives the port's loop
    to ``max_iters`` on the CPU: the init phase's switches happen, each
    with a measured positive cost, and the step cache holds the settings
    it built."""
    _, tcfg, _, _ = dense_models(0)
    job = LMJob(tcfg, batch=4, seq=16, seed=0, device="cpu")
    tuner = TuningManager(lm_knob_space(1), DEFAULT_LM_SETTING,
                          TunerConfig(eps=0.05, a=4, b=3, seed=0))
    loop = SelfTuningLoop(tuner, job.step_builder, job.state_adapter,
                          step_cache_size=4)
    state = job.init_state(DEFAULT_LM_SETTING, seed=0)
    res, state = loop.run(state, job.batches(0), max_iters=40)
    assert res.iterations == 40 or res.converged
    assert len(tuner.repo.reconfig_events) >= 3
    assert all(e["cost_s"] > 0 for e in tuner.repo.reconfig_events)
    assert np.isfinite(res.final_loss)
    assert loop._steps.stats()["size"] <= 4
    want = setting_to_stepknobs(tuner.current).staleness
    got = flatten(state["grad_queue"])[1][0].shape[0] if want else 0
    assert got == want


def test_mesh_plans_raise_not_ported(monkeypatch):
    """A plan with Type I-b (mesh_split, only in a multi-device space)
    needs as many ranks as its meshes have devices: in a one-process
    world the job says so (tests/test_torch_mesh.py runs such plans over
    four ranks); a one-device job takes the single-device step."""
    _, tcfg, _, _ = dense_models(0)
    job = LMJob(tcfg, batch=2, seq=8, device="cpu", n_devices=2)
    assert "mesh_split" in lm_knob_space(2).names()
    plan = trc.plan(dict(DEFAULT_LM_SETTING, mesh_split="2x1"),
                    dict(DEFAULT_LM_SETTING, mesh_split="1x2"))
    assert "I-b" in plan.kinds
    with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
        job.state_adapter({}, plan)
    one = LMJob(tcfg, batch=2, seq=8, device="cpu")
    assert one.n_devices == 1 and one.meshspec(DEFAULT_LM_SETTING).n_devices == 1
