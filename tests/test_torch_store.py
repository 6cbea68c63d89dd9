"""PyTorch port: the fleet tuning store (``repro_torch.store``) against the
JAX package's (``repro.store``), in both directions: the same signature
keys for the same traffic, a store written by either package read, merged,
compacted and reduced to the same golden table by the other, the seed
golden table resolved the same way, a ``TuningManager`` warm-started from
a store making the JAX tuner's decisions, and the store's concurrency
protocol (writer sessions in two OS processes, one of each package, a
torn final line)."""
import dataclasses
import json
import multiprocessing
import os
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

import repro.store as jstore
import repro_torch.store as tstore
from repro.configs.registry import get_config as jget_config
from repro.core.knobs import Knob as JKnob
from repro.core.knobs import KnobSpace as JKnobSpace
from repro.core.tuner import TunerConfig as JTunerConfig
from repro.core.tuner import TuningManager as JTuningManager
from repro_torch.configs.registry import get_config
from repro_torch.core.knobs import Knob, KnobSpace
from repro_torch.core.tuner import TunerConfig, TuningManager

ROOT = Path(__file__).resolve().parents[1]
KEY = "m1:dense:aaaaaaaa|paged:seq96|r5:p4:g4:s0"
PKG = {"jax": jstore, "port": tstore}
_Req = namedtuple("_Req", ("prompt", "max_new", "arrival_s"))


def _trace(seed, n=24, share=False):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 100, (16,))
    return [_Req(np.concatenate([head, rng.integers(0, 100, (8,))])
                 if share and i % 2 else rng.integers(0, 100, (4 + i,)),
                 4 + i % 5, 0.05 * i) for i in range(n)]


def test_schema_and_tiers_are_the_jax_packages():
    assert tstore.SCHEMA_FIELDS == jstore.SCHEMA_FIELDS
    assert tstore.signature.TIERS == jstore.signature.TIERS
    assert tstore.store.SCHEMA_VERSION == jstore.store.SCHEMA_VERSION
    assert tstore.golden.GOLDEN_VERSION == jstore.golden.GOLDEN_VERSION


@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_same_trace_same_signature_key(arch, reduced):
    """The two packages' ``ModelConfig`` hash to one model tag, and the
    same trace buckets to one workload: one key, so either package's runs
    pool their observations."""
    cfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    kind = "paged" if cfg.family == "dense" else "ssm"
    for seed, share in ((0, False), (1, True)):
        tr = _trace(seed, share=share)
        a = jstore.signature_from_trace(cfg, kind, 96, tr, 2.0)
        b = tstore.signature_from_trace(tcfg, kind, 96, tr, 2.0)
        assert a.key == b.key
    if arch == "zamba2-1.2b" and not reduced:
        assert tstore.model_tag(tcfg) == "zamba2-1.2b:hybrid:d242f8f3"


def _write(pkg, root, n_sessions=3):
    """Sessions of one package's store under two signatures: observations
    (one of them non-finite, dropped) and decisions."""
    store = PKG[pkg].TuningStore(str(root))
    other = "m1:dense:aaaaaaaa|paged:seq96|r6:p4:g4:s0"
    for i in range(n_sessions):
        sess = store.session(KEY if i % 2 == 0 else other)
        for j in range(4):
            sess.record_observation({"a": 2 ** j, "b": "xy"[i % 2]}, 1.0,
                                    float(4 - j + 0.1 * i))
        sess.record_observation({"a": 1}, 1.0, float("nan"))
        sess.record_decision({"window": i, "phase": "online",
                              "candidate": {"a": 8}, "incumbent": {"a": 1},
                              "switched": True, "reason": "ei>cost",
                              "ei_s": 0.5, "predicted_cost_s": 0.1})
        sess.close()
    return store


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_written_by_one_package_read_by_the_other(tmp_path, writer,
                                                         reader):
    """Records (observations and decisions), the warm-start resolution,
    the compaction and the golden table: the reader's equal the writer's
    own."""
    w = _write(writer, tmp_path)
    r = PKG[reader].TuningStore(str(tmp_path))
    assert r.read_records() == w.read_records()
    assert len(r.read_records(kinds=("obs",))) == 12
    assert r.observations_for(KEY) == w.observations_for(KEY)
    pool_sig = "m1:dense:aaaaaaaa|paged:seq96|r9:p9:g9:s0"
    assert r.observations_for(pool_sig) == w.observations_for(pool_sig)
    golden = w.build_golden()
    assert r.build_golden() == golden
    PKG[reader].check_golden(golden)
    assert r.compact() is True
    assert len(os.listdir(r.segments_dir)) == 1
    assert w.read_records() == r.read_records()
    assert w.build_golden() == golden
    table = r.write_golden()
    assert PKG[writer].load_golden(r.golden_path) == table == golden


def test_golden_seed_resolves_as_in_jax():
    """``artifacts/tuning/GOLDEN_seed.json``: the port loads it and
    resolves every kind of signature to the entry, key and tier
    ``repro.store.lookup`` gives."""
    path = str(ROOT / "artifacts" / "tuning" / "GOLDEN_seed.json")
    jt, tt = jstore.load_golden(path), tstore.load_golden(path)
    assert jt == tt
    tstore.check_golden(tt)
    (key,) = tt["entries"]
    model, pool, _ = key.split("|")
    for sig in (key, f"{model}|{pool}|r1:p2:g3:s0",
                f"x:{model.split(':')[1]}:00000000|ssm:seq8|r0:p0:g0:s0",
                "x:moe:00000000|paged:seq8|r0:p0:g0:s0"):
        got = tstore.lookup(tt, sig)
        assert got == jstore.lookup(jt, sig), sig
    assert tstore.lookup(tt, key)[2] == "exact"


class _TimeObjective:
    def window_score(self, iters, values, times):
        t = float(np.mean(times))
        return {"Y": t * 1000, "t_bar": t, "remaining_iters": 1000}

    peek = window_score

    def is_converged(self, repo):
        return False


def _true_time(s):
    return 0.1 / s["a"] + (0.05 if s["b"] == "y" else 0.0)


def _tuner(pkg, store, absorb=True, seed=0):
    knob, space, cfg_, mgr = ((JKnob, JKnobSpace, JTunerConfig,
                               JTuningManager) if pkg == "jax" else
                              (Knob, KnobSpace, TunerConfig, TuningManager))
    space = space((knob("a", "ordinal", (1, 2, 4, 8)),
                   knob("b", "nominal", ("x", "y"))))
    return mgr(space, {"a": 1, "b": "y"},
               cfg_(eps=1e-9, a=5, b=6, seed=seed, ei_rel_threshold=0.0),
               objective=_TimeObjective(), store=store, signature=KEY,
               absorb_history=absorb)


def _drive(tuner, quanta, seed):
    """Deterministic noisy times; returns the settings the tuner ran."""
    rng = np.random.default_rng(seed)
    seen = []
    for _ in range(quanta):
        t = _true_time(tuner.current) * (1 + 0.02 * rng.standard_normal())
        tuner.record_iteration(1.0, t)
        plan = tuner.maybe_advance()
        if plan is not None:
            tuner.record_reconfig(plan, 0.01)
        seen.append(dict(tuner.current))
    return seen


@pytest.mark.parametrize("warm", [False, True])
def test_tuning_manager_with_a_store_matches_jax(tmp_path, warm):
    """A JAX tuner seeds the store; then each package's TuningManager
    opened on it (absorbing or not) reports the same warm start (absorbed
    observations, tier, init settings skipped), runs the same settings
    quantum by quantum and writes the same observations back."""
    seeder = _tuner("jax", jstore.TuningStore(str(tmp_path / "seed")),
                    absorb=False)
    _drive(seeder, 120, seed=3)
    seeder.close_store()
    runs = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        __import__("shutil").copytree(tmp_path / "seed", root)
        tuner = _tuner(pkg, PKG[pkg].TuningStore(str(root)), absorb=warm)
        info = dict(tuner.warm_start_info)
        seen = _drive(tuner, 60, seed=4)
        tuner.close_store()
        obs = PKG[pkg].TuningStore(str(root)).read_records(kinds=("obs",))
        runs[pkg] = (info, seen, [(r["setting"], r["Y"]) for r in obs],
                     tuner.init_quanta)
    (ji, js, jo, jq), (ti, ts, to, tq) = runs["jax"], runs["port"]
    assert ti == ji
    if warm:
        assert ti["absorbed_obs"] > 0 and ti["tier"] == "exact"
        assert ti["init_settings_skipped"] == 6
    assert ts == js and tq == jq
    assert len(to) == len(jo)
    for (s1, y1), (s2, y2) in zip(to, jo):
        assert s1 == s2 and y1 == pytest.approx(y2, rel=1e-12, abs=1e-12)


def test_reader_skips_a_torn_final_line(tmp_path):
    store = tstore.TuningStore(str(tmp_path))
    sess = store.session(KEY)
    sess.record_observation({"a": 1}, 1.0, 1.0)
    sess.close()
    seg = os.path.join(store.segments_dir, os.listdir(store.segments_dir)[0])
    with open(seg, "a") as f:
        f.write('{"v": 1, "kind": "obs", "sig": "' + KEY)   # mid-append tear
    assert len(store.read_records(kinds=("obs",))) == 1
    assert len(jstore.TuningStore(str(tmp_path)).read_records(
        kinds=("obs",))) == 1


def test_open_session_blocks_compaction_across_packages(tmp_path):
    """A writer session of either package holds the shared flock: the
    other package's compactor is refused until it closes."""
    for writer, compactor in (("jax", "port"), ("port", "jax")):
        root = tmp_path / writer
        w = PKG[writer].TuningStore(str(root))
        sess = w.session(KEY)
        sess.record_observation({"a": 1}, 1.0, 1.0)
        c = PKG[compactor].TuningStore(str(root), lock_timeout_s=0.05)
        assert c.compact() is False
        sess.close()
        assert c.compact() is True


def _writer_proc(pkg, root, key, n, idx):
    store = (jstore if pkg == "jax" else tstore).TuningStore(
        root, lock_timeout_s=10.0)
    sess = store.session(key)
    for i in range(n):
        sess.record_observation({"writer": idx, "i": i}, 1.0, float(i + 1))
    sess.close()


def test_writer_processes_of_both_packages_and_a_compacting_reader(tmp_path):
    """A JAX writer and a port writer append concurrently from two OS
    processes while the port reads and tries to compact: nothing is lost
    or double-counted."""
    root, n = str(tmp_path), 40
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_writer_proc, args=(pkg, root, KEY, n, idx))
             for idx, pkg in enumerate(("jax", "port"))]
    for p in procs:
        p.start()
    store = tstore.TuningStore(root, lock_timeout_s=0.05)
    try:
        while any(p.is_alive() for p in procs):
            recs = store.read_records(kinds=("obs",))        # lock-free
            assert len(recs) <= 2 * n
            store.compact()
    finally:
        for p in procs:
            p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs)
    store.lock_timeout_s = 5.0
    assert store.compact() is True
    recs = store.read_records(kinds=("obs",))
    assert len(recs) == 2 * n
    per_writer = {0: set(), 1: set()}
    for r in recs:
        per_writer[r["setting"]["writer"]].add(r["setting"]["i"])
    assert per_writer[0] == per_writer[1] == set(range(n))
    stamps = [tuple(r["stamp"]) for r in recs]
    assert stamps == sorted(stamps) and len(set(stamps)) == 2 * n
    assert json.loads(json.dumps(recs)) == recs
