"""PyTorch port: online reconfiguration through the serving engine — the
JAX package's invariants (tests/test_staged_reconfig.py:80-288,
tests/test_serving.py:107-158) held by the port's engine: a staged
migration that races live decode writes keeps the logical KV, no token is
lost, an undrained shrink waits, a cancel restores the incumbent, a
re-block commits stop-the-world, a shrink while busy stays on the warmed
geometry, and every request serves the never-reconfigured tokens."""
import copy

import numpy as np
import pytest

from repro_torch.core.reconfig import plan
from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                 SERVING_RELAYOUT_KNOBS, Request,
                                 ServingEngine, serve_loop)

from _torch_port import dense_models

MAX_SEQ = 48


@pytest.fixture(scope="module")
def dense():
    return dense_models(0)


def _setting(**kw):
    return dict(DEFAULT_SERVING_SETTING, **kw)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in lens]


def _requests(vocab, lens, max_new=6, seed=0):
    return [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(vocab, lens, seed))]


def _engine(tp, tcfg, **setting):
    eng = ServingEngine(tp, tcfg, _setting(**setting), max_seq=MAX_SEQ,
                        device="cpu")
    eng.async_precompile = False
    return eng


def _reference(tp, tcfg, reqs):
    """Tokens of an engine that never reconfigures (one slot, f32 pool)."""
    eng = _engine(tp, tcfg)
    serve_loop(eng, [Request(rid=r.rid, prompt=r.prompt.copy(),
                             max_new=r.max_new) for r in reqs])
    return {r.rid: r.tokens_out for r in eng.finished}


def _plan(eng, **new):
    return plan(eng.setting, _setting(**{**eng.setting, **new}),
                mesh_knobs=SERVING_RELAYOUT_KNOBS)


def _logical_kv(eng):
    pool = eng.pool
    out = {}
    for s, req in enumerate(eng.slot_req):
        if req is None:
            continue
        w = int(eng.slot_pos[s])
        rows = {}
        for k, v in pool.kv.items():
            a = v.float().numpy()
            g = a[:, np.asarray(pool.tables[s])]
            rows[k] = g.reshape(a.shape[0], -1, a.shape[3], a.shape[4])[:, :w]
        out[s] = rows
    return out


# ------------------------------------- the JAX package's invariants, port

def test_background_migration_preserves_logical_kv(dense):
    """Background batches race live decode writes, then the commit: the
    logical KV is the pre-commit KV and the stop-the-world relayout's of a
    copied pool, prefix keys survive, and serving finishes with the
    never-reconfigured tokens."""
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2, block_size=8, prefix_share=True)
    reqs = _requests(tcfg.vocab_size, [5, 12, 17, 9], max_new=10, seed=3)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    target = _setting(max_batch=4, block_size=8, prefix_share=True)
    assert eng.pool.begin_migration(target)
    for _ in range(4):
        eng.step()
        eng.pool.migration_step(max_blocks=2)
    while eng.pool.migration_pending() > 0:
        eng.pool.migration_step(max_blocks=4)
    before = _logical_kv(eng)
    prefix_keys = set(eng.pool.prefix)
    shadow = copy.deepcopy(eng.pool)
    shadow.abort_migration()
    extents = eng._live_extents()
    mapping = eng.pool.finish_migration(extents)
    assert mapping is not None
    eng._adopt_slots(mapping)
    eng._drop_pool_steps()
    eng.pool.check_invariants()
    assert eng.pool.n_slots == 4
    after = _logical_kv(eng)
    smap = shadow.relayout(target, extents)
    for s, rows in before.items():
        for k in rows:
            np.testing.assert_array_equal(rows[k], after[mapping[s]][k])
            a = shadow.kv[k].float().numpy()
            g = a[:, np.asarray(shadow.tables[smap[s]])]
            g = g.reshape(a.shape[0], -1, a.shape[3], a.shape[4])
            np.testing.assert_array_equal(rows[k], g[:, :rows[k].shape[1]])
    assert prefix_keys <= set(eng.pool.prefix)
    while eng.has_work():
        eng.step()
    ref = _reference(tp, tcfg, reqs)
    assert len(eng.finished) == 4
    for r in eng.finished:
        assert r.tokens_out == ref[r.rid], f"request {r.rid} diverged"


def test_engine_staged_reconfig_no_token_loss(dense):
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2, block_size=8, prefix_share=True)
    eng.migrate_batch_blocks = 2
    reqs = _requests(tcfg.vocab_size, [5, 12, 17, 9, 21, 7], max_new=8,
                     seed=3)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    p = _plan(eng, max_batch=4)
    assert "I-b" in p.kinds
    eng.begin_reconfig(p)
    assert eng._staged["incremental"] and not eng._staged["todo"]
    staged_keys = set(eng._staged["graphs"])
    ticks = 0
    while eng._staged is not None and ticks < 100:
        eng.step()
        ticks += 1
    assert eng._staged is None, "staged reconfig never committed"
    (ev,) = eng.take_reconfig_events()
    assert ev["plan"] is p and ev["staged"] and ev["cost_s"] >= 0.0
    assert ev["bg_blocks"] > 0 and ev["bg_capture_failures"] == 0
    assert eng.setting["max_batch"] == 4 and eng.pool.n_slots == 4
    # the steps captured on the staged buffer are the new pool's
    assert staged_keys and all(k[4:] == eng.pool.exec_key()
                               for k in staged_keys)
    assert staged_keys <= set(eng._steps._d)
    eng.pool.check_invariants()
    while eng.has_work():
        eng.step()
    ref = _reference(tp, tcfg, reqs)
    assert len(eng.finished) == 6
    for r in eng.finished:
        assert r.tokens_out == ref[r.rid], f"request {r.rid} diverged"


def test_engine_staged_shrink_drains_then_commits(dense):
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=3, block_size=8)
    for r in _requests(tcfg.vocab_size, [8] * 5, max_new=6, seed=2):
        eng.submit(r)
    eng.step()
    assert eng.n_active == 3
    eng.begin_reconfig(_plan(eng, max_batch=1))
    assert eng._max_batch_cap() == 1
    ticks = 0
    while eng._staged is not None and ticks < 150:
        eng.step()
        ticks += 1
    assert eng._staged is None and eng.pool.n_slots == 1
    while eng.has_work():
        eng.step()
    assert len(eng.finished) == 5
    assert all(len(r.tokens_out) == r.max_new for r in eng.finished)


def test_engine_cancel_staged_restores_incumbent(dense):
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2, block_size=8)
    eng.migrate_batch_blocks = 1
    for r in _requests(tcfg.vocab_size, [20, 20], max_new=6, seed=4):
        eng.submit(r)
    eng.step()
    steps = set(eng._steps._d)
    p = _plan(eng, max_batch=4)
    eng.begin_reconfig(p)
    eng.step()
    assert eng._staged is not None
    assert eng.cancel_staged() is p and eng._staged is None
    assert eng.pool._mig is None and eng.pool.n_slots == 2
    assert set(eng._steps._d) >= steps      # the incumbent's steps stay
    eng.pool.check_invariants()
    while eng.has_work():
        eng.step()
    assert all(len(r.tokens_out) == r.max_new for r in eng.finished)


def test_block_size_change_commits_stop_the_world(dense):
    """A re-block cannot stage: the plan commits at the next tick through
    the stop-the-world relayout, and the old geometry's steps are gone."""
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2, block_size=8)
    reqs = _requests(tcfg.vocab_size, [11, 14], max_new=8, seed=5)
    for r in reqs:
        eng.submit(r)
    eng.step()
    old_key = eng.pool.exec_key()
    eng.begin_reconfig(_plan(eng, block_size=16))
    assert not eng._staged["incremental"]
    eng.step()
    (ev,) = eng.take_reconfig_events()
    assert not ev["staged"] and ev["measured"]["I-b"] > 0
    assert eng.pool.bs == 16
    assert not any(k[0] == "decode" and k[4:] == old_key
                   for k in eng._steps._d)
    while eng.has_work():
        eng.step()
    ref = _reference(tp, tcfg, reqs)
    for r in eng.finished:
        assert r.tokens_out == ref[r.rid]


def test_shrink_while_busy_stays_on_warmed_geometry(dense):
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=4)
    reqs = _requests(tcfg.vocab_size, [5, 9, 12], max_new=8)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert eng.n_active == 3
    eng.apply_plan(_plan(eng, max_batch=2))
    assert eng.n_slots == 4          # held, not shrunk to len(live) = 3
    while eng.has_work():
        eng.step()
    assert eng.n_slots == 2          # the deferred shrink on drain
    ref = _reference(tp, tcfg, reqs)
    for r in eng.finished:
        assert r.tokens_out == ref[r.rid]


def test_relayout_preserves_live_requests(dense):
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2)
    reqs = _requests(tcfg.vocab_size, [5, 12], max_new=8)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert eng.n_active == 2
    cost = eng.apply_plan(_plan(eng, max_batch=4))
    assert cost > 0 and eng.n_slots >= 4
    assert eng.last_reconfig_scales["I-b"] == eng.pool.last_relayout_blocks
    while eng.has_work():
        eng.step()
    ref = _reference(tp, tcfg, reqs)
    for r in eng.finished:
        assert r.tokens_out == ref[r.rid]


class _OnePlanTuner:
    """Proposes one staged grow after two quanta and records what the
    driver reports: each quantum's tick time and the switch's cost."""

    def __init__(self, new):
        self.new = new
        self.dts, self.costs = [], []
        self.pending = None
        self.init_quanta, self.init_time_s = 0, 0.0
        self.warm_start_info = None

    def record_iteration(self, load, dt):
        self.dts.append(dt)

    def maybe_advance(self):
        if len(self.dts) == 2:
            self.pending = plan(self.new["old"], self.new["new"],
                                mesh_knobs=SERVING_RELAYOUT_KNOBS)
            return self.pending
        return None

    def record_reconfig(self, p, cost_s, measured=None, scales=None):
        self.costs.append((cost_s, measured, scales))

    def abandon_reconfig(self, p):
        raise AssertionError("the staged grow was abandoned")

    def effective_horizon(self):
        return None


def test_serve_loop_charges_the_staged_work_to_the_switch(dense):
    """The staged captures and block copies run between ticks on the tick's
    thread, so the switch is charged the commit plus that work (stall_s,
    its I-b share and every block it copied), and the incumbent's quanta
    are recorded without it."""
    _, tcfg, _, tp = dense
    eng = _engine(tp, tcfg, max_batch=2, block_size=8)
    eng.async_precompile = True           # one capture per quantum
    eng.migrate_batch_blocks = 1
    old = dict(eng.setting)
    tuner = _OnePlanTuner({"old": old, "new": {**old, "max_batch": 4}})
    events, ticks = [], []
    take, step = eng.take_reconfig_events, eng.step

    def take_logged():
        ev = take()
        events.extend(ev)
        return ev

    def step_logged(now=None):
        t = step(now=now)
        ticks.append(t)
        return t

    eng.take_reconfig_events, eng.step = take_logged, step_logged
    reqs = _requests(tcfg.vocab_size, [5, 12, 17, 9], max_new=10, seed=4)
    stats = serve_loop(eng, reqs, tuner)
    assert stats["completed"] == 4 and eng.setting["max_batch"] == 4
    (ev,) = events
    assert ev["staged"] and ev["bg_precompile_s"] > 0 and ev["bg_blocks"] > 0
    bg = ev["bg_migrate_s"] + ev["bg_precompile_s"]
    assert ev["stall_s"] == pytest.approx(ev["cost_s"] + bg, abs=1e-12)
    ((cost, measured, scales),) = tuner.costs
    assert cost == ev["stall_s"] and stats["reconfig_total_s"] == cost
    assert measured["I-b"] >= bg
    assert scales["I-b"] == ev["bg_blocks"] + ev["delta_blocks"]
    busy = [t for t in ticks if not t["idle"]]
    assert any(t["reconfig_s"] > 0 for t in busy)
    assert tuner.dts == [t["dt"] - t["reconfig_s"] for t in busy]
