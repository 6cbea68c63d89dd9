"""PyTorch port: the serving engine against the JAX engine under the same
plan sequence — ``apply_plan`` and ``begin_reconfig`` mid-serve on reduced
starcoder2-3b and falcon-mamba-7b serve the same tokens (tie-aware,
ROADMAP C1) with the same settings, geometries and block tables after
every tick, and ``serve_loop`` with a stub tuner that emits fixed plans at
fixed quanta reports the same reconfigurations on both sides."""
import numpy as np
import pytest

from repro.core.reconfig import plan as jplan
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro_torch.core.reconfig import plan
from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                 SERVING_RELAYOUT_KNOBS, Request,
                                 ServingEngine, serve_loop)

from _torch_port import dense_models, ssm_models, tie_aware_check

MAX_SEQ = 48


@pytest.fixture(scope="module")
def dense():
    return dense_models(0)


@pytest.fixture(scope="module")
def ssm():
    return ssm_models(0)


def _setting(**kw):
    return dict(DEFAULT_SERVING_SETTING, **kw)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in lens]


PLANS = {
    "dense": [(2, "apply", dict(max_batch=4)),
              (4, "apply", dict(block_size=8, cache_dtype="bf16")),
              (6, "stage", dict(max_batch=2)),
              (9, "stage", dict(k_chunk=256, prefill_chunk=32))],
    "ssm": [(2, "apply", dict(max_batch=4, cache_dtype="bf16")),
            (5, "stage", dict(max_batch=2)),
            (8, "stage", dict(cache_dtype="f32"))],
}


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_engine_reconfigs_match_jax_engine(dense, ssm, family):
    cfg, tcfg, jp, tp = dense if family == "dense" else ssm
    setting = _setting(max_batch=3, block_size=16, cache_dtype="f32",
                       prefix_share=family == "dense")
    prompts = _prompts(cfg.vocab_size, [5, 12, 17, 9, 21, 7], seed=8)
    je = JEngine(jp, cfg, setting, max_seq=MAX_SEQ)
    te = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    je.async_precompile = te.async_precompile = False
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p.copy(), max_new=8))
        te.submit(Request(rid=i, prompt=p.copy(), max_new=8))
    todo = list(PLANS[family])
    tick = 0
    while je.has_work() or te.has_work():
        je.step()
        te.step()
        tick += 1
        assert je._staged is None and te._staged is None or (
            je._staged is not None and te._staged is not None), tick
        if todo and todo[0][0] == tick:
            _, how, new = todo.pop(0)
            target = _setting(**{**je.setting, **new})
            pj = jplan(je.setting, target,
                       mesh_knobs=SERVING_RELAYOUT_KNOBS)
            pt = plan(te.setting, target, mesh_knobs=SERVING_RELAYOUT_KNOBS)
            assert pt.kinds == pj.kinds
            if how == "apply":
                je.apply_plan(pj)
                te.apply_plan(pt)
            else:
                je.begin_reconfig(pj)
                te.begin_reconfig(pt)
        assert te.setting == je.setting and te.n_slots == je.n_slots
        assert te.pool.exec_key() == je.pool.exec_key()
        if family == "dense":
            np.testing.assert_array_equal(te.pool.tables, je.pool.tables)
        assert tick < 200
    assert not todo
    assert [e["plan"].kinds for e in te.take_reconfig_events()] == [
        e["plan"].kinds for e in je.take_reconfig_events()]
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    assert sorted(tout) == sorted(jout) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        assert len(tout[i]) == 8
        tie_aware_check(jp, cfg, p, jout[i], tout[i])


class StubTuner:
    """Emits fixed plans after fixed numbers of recorded quanta and
    records what the driver reports."""

    def __init__(self, plan_fn, schedule):
        self.plan_fn = plan_fn
        self.schedule = list(schedule)     # (quantum, new settings dict)
        self.current = None
        self.n = 0
        self.committed, self.abandoned = [], []
        self.init_quanta, self.init_time_s = 0, 0.0
        self.warm_start_info = None
        self._pending = None

    def record_iteration(self, load, dt):
        self.n += 1

    def maybe_advance(self):
        if self._pending is None and self.schedule \
                and self.n >= self.schedule[0][0]:
            _, new = self.schedule.pop(0)
            self._pending = self.plan_fn(self.current, new)
            self.current = dict(self._pending.new)
            return self._pending
        return None

    def record_reconfig(self, p, cost_s, measured=None, scales=None):
        self.committed.append((p.kinds, dict(p.new)))
        self._pending = None

    def abandon_reconfig(self, p):
        self.abandoned.append(p.kinds)

    def effective_horizon(self):
        return None


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_serve_loop_with_a_stub_tuner_matches_jax(dense, ssm, family):
    cfg, tcfg, jp, tp = dense if family == "dense" else ssm
    setting = _setting(max_batch=2, block_size=16, cache_dtype="f32")
    schedule = [(3, dict(max_batch=4)), (6, dict(prefill_chunk=32)),
                (9, dict(cache_dtype="bf16"))]
    if family == "dense":
        schedule.append((12, dict(block_size=8)))
    prompts = _prompts(cfg.vocab_size, [6, 13, 4, 19, 8, 11, 15, 3], seed=2)

    def run(engine_cls, req_cls, loop, plan_fn, params, c):
        eng = engine_cls(params, c, setting, max_seq=MAX_SEQ,
                         **({} if engine_cls is JEngine else
                            {"device": "cpu"}))
        eng.async_precompile = False
        tuner = StubTuner(
            lambda cur, new: plan_fn(cur or eng.setting,
                                     {**(cur or eng.setting), **new},
                                     mesh_knobs=SERVING_RELAYOUT_KNOBS),
            schedule)
        stats = loop(eng, [req_cls(rid=i, prompt=p.copy(), max_new=7)
                           for i, p in enumerate(prompts)], tuner)
        return eng, tuner, stats

    je, jt, js = run(JEngine, JRequest, j_serve_loop, jplan, jp, cfg)
    te, tt, ts = run(ServingEngine, Request, serve_loop, plan, tp, tcfg)
    assert ts["completed"] == js["completed"] == len(prompts)
    assert ts["reconfig_count"] == js["reconfig_count"] == len(schedule)
    assert [(r["kinds"], r["setting"]) for r in ts["reconfigs"]] == [
        (r["kinds"], r["setting"]) for r in js["reconfigs"]]
    assert tt.committed == jt.committed and not tt.abandoned
    assert ts["final_setting"] == js["final_setting"]
    assert all(r["bg_capture_failures"] == 0 for r in ts["reconfigs"])
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for i, p in enumerate(prompts):
        tie_aware_check(jp, cfg, p, jout[i], tout[i])
