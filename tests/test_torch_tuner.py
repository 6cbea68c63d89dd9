"""PyTorch port: the tuning stack (numpy copies of the JAX package's
``core`` modules) against the JAX package on the same seeds, spaces and
observations — the GP posterior within 1e-12, EI after the port's clamp at
0 (ROADMAP C2), the cost model's estimates, ``classify``/``plan``, and a
``TuningManager`` driven through the same (load, dt) sequence and commit
reports on both sides emitting the same Latin-hypercube init settings and
the same ``ReconfigPlan``s."""
import numpy as np
import pytest

from repro.core import bo as jbo
from repro.core import reconfig as jrc
from repro.core.gp import GaussianProcess as JGP
from repro.core.tuner import TunerConfig as JTunerConfig
from repro.core.tuner import TuningManager as JTuningManager
from repro.serving.knobs import serving_knob_space as j_space
from repro.serving.objective import ServingObjective as JObjective
from repro_torch.core import bo as tbo
from repro_torch.core import reconfig as trc
from repro_torch.core.gp import GaussianProcess as TGP
from repro_torch.core.tuner import TunerConfig, TuningManager
from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingObjective
from repro_torch.serving.knobs import SERVING_RELAYOUT_KNOBS
from repro_torch.serving.knobs import serving_knob_space as t_space

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline: fixed-seed fallback shim
    from _hypothesis_compat import given, settings, strategies as st

GP_TOL = 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_posterior_matches_jax(seed):
    rng = np.random.default_rng(seed)
    X = rng.random((12, 5))
    y = rng.standard_normal(12)
    Xs = rng.random((40, 5))
    for optimize in (False, True):
        jm, js = JGP().fit(X, y, optimize=optimize).predict(Xs)
        tm, ts = TGP().fit(X, y, optimize=optimize).predict(Xs)
        np.testing.assert_allclose(tm, jm, rtol=0, atol=GP_TOL)
        np.testing.assert_allclose(ts, js, rtol=0, atol=GP_TOL)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-3.0, 3.0), min_size=1, max_size=6),
       st.floats(1e-13, 2.0), st.floats(-3.0, 3.0))
def test_ei_is_the_jax_ei_clamped_at_zero(mus, sigma, best):
    mu = np.asarray(mus, float)
    sig = np.full_like(mu, sigma)
    want = np.maximum(jbo.expected_improvement(mu, sig, best), 0.0)
    got = tbo.expected_improvement(mu, sig, best)
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GP_TOL)


def test_ei_clamps_the_c2_examples():
    """The two inputs where the JAX EI comes out a few ulps below 0."""
    for mu, best in (([0.0], -0.8046875), ([0.0, 0.0, -0.537109375],
                                           -2.625)):
        mu = np.asarray(mu)
        sig = np.full_like(mu, 0.1)
        assert (tbo.expected_improvement(mu, sig, best) >= 0).all()


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_bo_suggestions_match_jax(family):
    """Same observations into both LossAwareBOs: the same candidate, EI and
    best, cost-blind and cost-aware, on the serving space."""
    js, ts = j_space(family=family), t_space(family=family)
    jb, tb = jbo.LossAwareBO(js, seed=3), tbo.LossAwareBO(ts, seed=3)
    rng = np.random.default_rng(7)
    import random
    samp = random.Random(11)
    for _ in range(9):
        s = js.sample(samp)
        loss, Y = float(rng.uniform(1, 8)), float(rng.uniform(0.5, 4))
        jb.observe(s, loss, Y)
        tb.observe(dict(s), loss, Y)
    cur = dict(DEFAULT_SERVING_SETTING, max_batch=2)
    cur = {k: v for k, v in cur.items() if k in js.names()}

    def cost(c):
        return 0.3 if c.get("max_batch") != cur["max_batch"] else 0.01

    for kw in ({}, {"cost_fn": cost, "horizon_s": 20.0}):
        jx, jei, jbest = jb.suggest(4.0, cur, **kw)
        tx, tei, tbest = tb.suggest(4.0, cur, **kw)
        assert abs(tbest - jbest) <= GP_TOL * max(1.0, abs(jbest))
        if jei > 0:          # where every JAX EI <= 0 the argmax may differ
            assert tx == jx
            assert abs(tei - jei) <= 1e-9 * max(1.0, abs(jei))
        if kw:
            assert tb.last_decision.keys() == jb.last_decision.keys()


def test_cost_model_estimates_match_jax():
    jm, tm = jrc.ReconfigCostModel(), trc.ReconfigCostModel()
    obs = [(("I-b", "II"), 0.4, {"I-b": 0.3}, {"I-b": 12}),
           (("II",), 2.5, None, None), (("I-b",), 0.05, None, {"I-b": 3}),
           (("II",), 0.02, None, None), (("I-b", "II"), 0.1, None, None)]
    for kinds, cost, meas, scales in obs:
        assert (tm.observe(kinds, cost, measured=meas, scales=scales)
                == jm.observe(kinds, cost, measured=meas, scales=scales))
        for q in (("I-b",), ("II",), ("I-b", "II"), ("I-a",)):
            for sc in (None, {"I-b": 5}):
                a = jm.estimate_breakdown(q, scales=sc)
                b = tm.estimate_breakdown(q, scales=sc)
                assert tuple(b) == tuple(a)
    assert tm.avgs == jm.avgs and tm.unit_avgs == jm.unit_avgs


CLASSIFY_CASES = [
    ({"mesh_split": "4x2", "remat": "none", "data_shards": 4},
     {"mesh_split": "2x4"}, {}),
    ({"mesh_split": "4x2", "remat": "none"}, {"remat": "full"}, {}),
    ({"data_shards": 4}, {"data_shards": 8}, {}),
    ({"mesh_split": "4x2", "remat": "none"},
     {"mesh_split": "2x4", "remat": "full"}, {}),
    ({}, {}, {}),
    ({"remat": "full"}, {"remat": "full"}, {}),
    ({}, {"mesh_split": "2x4"}, {}),
    ({"mesh_split": "a", "data_shards": 1, "remat": "none"},
     {"mesh_split": "b", "data_shards": 2, "remat": "full"}, {}),
    ({"max_batch": 1, "quant": "none"}, {"max_batch": 8, "quant": "int8"},
     {"mesh_knobs": ("max_batch", "cache_dtype")}),
    ({"max_batch": 1}, {"max_batch": 8},
     {"mesh_knobs": SERVING_RELAYOUT_KNOBS}),
    ({"block_size": 16, "spec_k": 0.0}, {"block_size": 8, "spec_k": 2.0},
     {"mesh_knobs": SERVING_RELAYOUT_KNOBS}),
]


@pytest.mark.parametrize("case", range(len(CLASSIFY_CASES)))
def test_classify_and_plan_match_jax(case):
    old, upd, kw = CLASSIFY_CASES[case]
    new = {**old, **upd}
    assert trc.classify(old, new, **kw) == jrc.classify(old, new, **kw)
    for odmr in (True, False):
        a = jrc.plan(old, new, odmr, **kw)
        b = trc.plan(old, new, odmr, **kw)
        assert (b.kinds, b.old, b.new, b.method, b.needs_relocation) == (
            a.kinds, a.old, a.new, a.method, a.needs_relocation)


class _Req:
    def __init__(self, lat):
        self.latency_s = lat


class _Pool:
    kind = "paged"

    def __init__(self):
        self.held = 4

    def snapshot(self):
        return {"blocks_held": self.held, "live_slots": 2}


class _Engine:
    """What ServingObjective reads of an engine, driven by the test."""

    def __init__(self):
        self.total_tokens = 0
        self.finished = []
        self.pool = _Pool()


def _drive(tuner, eng, n_iter: int, commit_after: int, seed: int):
    """(load, dt) per quantum from a seeded synthetic service model — dt
    depends on the tuner's incumbent, so the GP sees a real surface — with
    each plan committed ``commit_after`` quanta later (a staged commit)
    and reported with a seeded cost.  Returns the plans and the init
    settings in the order they came."""
    rng = np.random.default_rng(seed)
    plans, pending, due = [], None, 0
    for i in range(n_iter):
        cur = tuner.current
        load = float(rng.integers(1, 12))
        speed = (cur.get("max_batch", 1) ** 0.5
                 * (1.3 if cur.get("cache_dtype") == "bf16" else 1.0)
                 / (1 + 0.2 * float(cur.get("spec_k", 0.0))))
        dt = float(0.01 * load / speed * rng.uniform(0.9, 1.1))
        eng.total_tokens += int(load)
        if i % 7 == 0:
            eng.finished.append(_Req(float(rng.uniform(0.1, 5.0))))
        eng.pool.held = int(rng.integers(1, 40))
        tuner.record_iteration(load, dt)
        if pending is not None and i >= due:
            cost = float(rng.uniform(0.001, 0.2))
            tuner.record_reconfig(pending, cost,
                                  measured={"I-b": cost / 2}
                                  if "I-b" in pending.kinds else {},
                                  scales={"I-b": eng.pool.held})
            pending = None
        p = tuner.maybe_advance()
        if p is not None:
            plans.append(p)
            pending, due = p, i + commit_after
    return plans


@pytest.mark.parametrize("family,b,commit_after", [("dense", 5, 3),
                                                   ("ssm", 4, 0)])
def test_tuning_manager_emits_the_jax_plans(family, b, commit_after):
    x0 = dict(DEFAULT_SERVING_SETTING, max_batch=2)
    kw = dict(eps=1e-6, a=6, b=b, seed=5, drift_z=3.0, window_time_s=0.5,
              amortize_horizon_s=20.0, adapt_horizon=True)
    je, te = _Engine(), _Engine()
    jt = JTuningManager(j_space(family=family), x0, JTunerConfig(**kw),
                        objective=JObjective(je, slo_p99_s=2.0),
                        reconfig_knob_classes={
                            "mesh_knobs": SERVING_RELAYOUT_KNOBS})
    tt = TuningManager(t_space(family=family), x0, TunerConfig(**kw),
                       objective=ServingObjective(te, slo_p99_s=2.0),
                       reconfig_knob_classes={
                           "mesh_knobs": SERVING_RELAYOUT_KNOBS})
    assert tt._init_queue == jt._init_queue          # the LHS init settings
    assert len(tt._init_queue) == b
    jp = _drive(jt, je, 400, commit_after, seed=9)
    tp = _drive(tt, te, 400, commit_after, seed=9)
    assert len(jp) > b, "the tuner never reached its online phase"
    assert [(p.kinds, p.old, p.new, p.method) for p in tp] == [
        (p.kinds, p.old, p.new, p.method) for p in jp]
    assert tt.current == jt.current and tt.phase == jt.phase == "online"
    assert [h["setting"] for h in tt.history] == [
        h["setting"] for h in jt.history]
    np.testing.assert_allclose([h["Y"] for h in tt.history],
                               [h["Y"] for h in jt.history],
                               rtol=0, atol=GP_TOL)
    assert [r["type"] for r in tt.audit.records] == [
        r["type"] for r in jt.audit.records]
    assert tt.costs.avgs == jt.costs.avgs


def test_tuner_attaches_a_store(tmp_path):
    """A TuningManager given a store opens a writer session, records its
    warm start in the audit and releases the lock on ``close_store``
    (tests/test_torch_store.py holds the warm start to the JAX tuner)."""
    from repro_torch.store import TuningStore
    store = TuningStore(str(tmp_path))
    key = "m:dense:00000000|paged:seq96|r5:p4:g4:s0"
    tm = TuningManager(t_space(), dict(DEFAULT_SERVING_SETTING),
                       TunerConfig(eps=1e-6), store=store, signature=key)
    assert tm.warm_start_info == {
        "store_key": key, "read_only": False, "matched_key": None,
        "tier": None, "absorbed_obs": 0, "init_settings_skipped": 0}
    assert tm.audit.records[-1]["type"] == "warm_start"
    assert store.compact() is False            # the session holds the lock
    tm.close_store()
    assert store.compact() is True
