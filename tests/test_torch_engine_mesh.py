"""PyTorch port: the serving engine under a mesh, on the CPU.

(a) the JAX engine under ``single_device_meshspec()`` against the port's
engine under its own 1x1 ``MeshSpec``, over ``test_torch_engine.py``'s
requests on reduced starcoder2-3b (prefix sharing x int8) and on reduced
falcon-mamba-7b: tokens tie-aware, the prefill and sharing counters
equal; (b) the pools' placement: ``param_specs`` and ``param_shardings``
of each family's pool (dense, ssm, hybrid) equal to the JAX package's
``param_specs`` on shape-only 1x1, 2x2 and 2x2x2 meshes, and
``relocate_now`` keeping every pool tensor itself; (c) one 4-rank gloo
job (``_worker``: this file run as a script, importing the port only)
serving through ``serve_loop`` in lockstep, a one-plan tuner on rank 0
staging a Type I-b relayout mid-run: reduced starcoder2-3b on 2x2
(parameters whole, and fsdp shards, with int8 KV) and on 4x1 (fsdp, the
n-gram drafter's S = 3 verify, a shrink to 2 slots that the 4 data ranks
do not divide), reduced falcon-mamba-7b on 2x2 (fsdp, the truncated
drafter and the snapshot replay) and reduced zamba2-1.2b on 2x2 (its KV
slab): every rank's scheduler state and pool after every tick, its
finished requests, block tables and pool bit for bit alike; tokens
tie-aware against the single-process engine; every request complete and
no block leaked.
"""
from __future__ import annotations

import datetime
import hashlib
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
MAX_SEQ = 48
# tie-aware tokens against the single-process engine: at the first token
# that differs, the reference's logits (the port's prefill over the prompt
# and the reference tokens so far) rank the mesh engine's token within four
# bf16 steps of its own (``_torch_port.LOGIT_TOL``)
LOGIT_TOL = 4 / 64
BASE = {"max_batch": 4, "block_size": 8, "prefix_share": True}
# (arch, mesh, parameter placement, setting, the staged plan's knobs)
CASES = {
    "dense-2x2-whole": ("starcoder2-3b", (2, 2), None, {},
                        {"max_batch": 8}),
    "dense-2x2-fsdp-int8": ("starcoder2-3b", (2, 2), "fsdp",
                            {"quant": "int8"}, {"max_batch": 8}),
    "dense-4x1-fsdp-spec": ("starcoder2-3b", (4, 1), "fsdp",
                            {"spec_k": 2.0, "drafter": "ngram"},
                            {"max_batch": 2}),
    "ssm-2x2-fsdp-spec": ("falcon-mamba-7b", (2, 2), "fsdp",
                          {"spec_k": 2.0, "drafter": "truncated"},
                          {"max_batch": 2}),
    "hybrid-2x2-whole": ("zamba2-1.2b", (2, 2), None, {},
                         {"max_batch": 8}),
}
PLAN_AT = 3                       # busy quanta before the tuner's plan


def _prompts(vocab: int) -> list:
    """Two 16-token templates with tails, one prompt that is a whole
    template (a full prefix match: copy-on-write), unrelated prompts."""
    rng = np.random.default_rng(4)
    tpl = [rng.integers(0, vocab, (16,)).astype(np.int32) for _ in range(2)]
    out = [np.concatenate([tpl[i % 2], rng.integers(0, vocab, (3 + i,))
                           .astype(np.int32)]) for i in range(5)]
    out.insert(1, tpl[0].copy())
    out += [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (11, 7)]
    return out


def _requests(vocab: int):
    from repro_torch.serving import Request
    return [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(_prompts(vocab))]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as integers (bf16 as int16, f32 as int32)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(ints[t.element_size()]).numpy()


def _pool_tensors(eng) -> dict:
    return eng.pool.kv if eng.pool.kind == "paged" else eng.pool.state


def _digest(eng) -> str:
    """The engine's scheduler state and pool after a tick."""
    h = hashlib.sha256(repr((
        [None if r is None else r.rid for r in eng.slot_req],
        eng.slot_pos.tolist(), eng.slot_tok.tolist(),
        [r.rid for r in eng.queue], [r.rid for r in eng.finished],
        dict(eng.setting))).encode())
    if eng.pool.kind == "paged":
        h.update(eng.pool.tables.tobytes())
    for k, t in sorted(_pool_tensors(eng).items()):
        h.update(_bits(t).tobytes())
    return h.hexdigest()


class OnePlan:
    """A tuner that proposes one plan (``new`` over the engine's setting)
    after its ``at``-th busy quantum and keeps what the loop reports."""
    init_quanta, init_time_s, warm_start_info = 0, 0.0, None

    def __init__(self, eng, new: dict, at: int = PLAN_AT):
        self.eng, self.new, self.at, self.n = eng, new, at, 0
        self.committed, self.abandoned = [], []

    def record_iteration(self, load, dt):
        self.n += 1

    def maybe_advance(self):
        if self.n != self.at:
            return None
        from repro_torch.core.reconfig import plan
        from repro_torch.serving import SERVING_RELAYOUT_KNOBS
        return plan(self.eng.setting, {**self.eng.setting, **self.new},
                    mesh_knobs=SERVING_RELAYOUT_KNOBS)

    def record_reconfig(self, plan, cost_s, measured=None, scales=None):
        self.committed.append(dict(plan.new))

    def abandon_reconfig(self, plan):
        self.abandoned.append(dict(plan.new))

    def effective_horizon(self):
        return None


def serve_case(name: str, ms=None, rank: int = 0) -> dict:
    """One case of ``CASES`` through ``serve_loop``: under ``ms`` this
    rank's engine (its parameter shards where the case says so), else the
    single-process engine.  Returns what the tests compare."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed.sharding import shard
    from repro_torch.models import lm
    from repro_torch.ps.stepfn import StepKnobs, serve_param_specs
    from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                     serve_loop)
    arch, _, placement, extra, new = CASES[name]
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    specs = None
    if ms is not None and placement is not None:
        specs = serve_param_specs(cfg, ms, StepKnobs(serve_params=placement))
        params = tree_map(lambda x, sp: shard(x, sp, ms).contiguous(),
                          params, specs)
    setting = dict(DEFAULT_SERVING_SETTING, **BASE, **extra)
    eng = ServingEngine(params, cfg, setting, max_seq=MAX_SEQ, device="cpu",
                        ms=ms, param_specs=specs)
    digests = []
    tick = eng.step

    def step(now=None):
        out = tick(now)
        digests.append(_digest(eng))
        return out

    eng.step = step
    tuner = OnePlan(eng, new)
    stats = serve_loop(eng, _requests(cfg.vocab_size), tuner)
    pool = eng.pool
    snap = pool.snapshot()
    if pool.kind == "paged":
        pool.check_invariants()
    return {"rank": rank, "coord": None if ms is None else ms.coord,
            "finished": [(r.rid, list(r.tokens_out)) for r in eng.finished],
            "digests": digests, "setting": dict(eng.setting),
            "tables": pool.tables.copy() if pool.kind == "paged" else None,
            "pool": {k: _bits(t) for k, t in _pool_tensors(eng).items()},
            "completed": stats["completed"], "requests": stats["requests"],
            "reconfigs": [(r["staged"], r["setting"])
                          for r in stats["reconfigs"]],
            "committed": tuner.committed, "abandoned": tuner.abandoned,
            "live": pool.n_active, "snapshot": snap,
            "spec_accepted": stats["speculation"]["accepted"],
            "shared_blocks_hit": stats["shared_blocks_hit"]}


def _worker(rank: int, d: str):
    import traceback

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_meshspec
    torch.manual_seed(0)
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{d}/store", rank, WORLD,
                     timeout=datetime.timedelta(seconds=60))
    meshes = {shape: make_meshspec(*shape) for shape in ((2, 2), (4, 1))}
    out = {}
    for name, case in CASES.items():
        t0 = time.perf_counter()
        try:
            out[name] = serve_case(name, meshes[case[1]], rank)
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
# the parent: the job, the single-process references
# =====================================================================

@pytest.fixture(scope="module")
def engine_run(tmp_path_factory):
    """The 4-rank job's results, and the single-process engine's on the
    same cases, computed here while the job runs."""
    d = tmp_path_factory.mktemp("engine_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    logs = [open(d / f"log{r}", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(d)], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        refs = {name: serve_case(name) for name in CASES}
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        text = []
        for f in logs:
            f.seek(0)
            text.append(f.read())
            f.close()
    ranks = []
    for r in range(WORLD):
        try:
            with open(d / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        except FileNotFoundError:
            ranks.append({})
    return {"ranks": ranks, "logs": text, "refs": refs,
            "seconds": time.perf_counter() - t0}


def _ok(run, case):
    res = []
    for r, ranks in enumerate(run["ranks"]):
        assert case in ranks, f"rank {r}:\n{run['logs'][r][-4000:]}"
        assert "error" not in ranks[case], \
            f"rank {r}: {ranks[case]['error']}"
        res.append(ranks[case])
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_the_same_state_after_every_tick(engine_run, case):
    """After every tick: the slots' requests, positions and last tokens,
    the queue, the finished order, the setting, the block tables and every
    pool tensor bit for bit alike on the four ranks; at the end the same
    finished requests, tables and pool."""
    res = _ok(engine_run, case)
    want = res[0]
    assert len(want["digests"]) > PLAN_AT
    for got in res[1:]:
        assert len(got["digests"]) == len(want["digests"]), got["rank"]
        bad = [t for t, (a, b) in enumerate(zip(want["digests"],
                                                got["digests"])) if a != b]
        assert not bad, f"rank {got['rank']} differs after ticks {bad}"
        assert got["finished"] == want["finished"], got["rank"]
        if want["tables"] is not None:
            np.testing.assert_array_equal(got["tables"], want["tables"])
        assert sorted(got["pool"]) == sorted(want["pool"])
        for k, v in want["pool"].items():
            np.testing.assert_array_equal(got["pool"][k], v, err_msg=k)


def _tie_aware(params, cfg, prompt, ref, got):
    """Equal greedy tokens, but at the first mismatch: the port's prefill
    logits over the prompt and ``ref[:t]`` rank ``got[t]`` within
    LOGIT_TOL of ``ref[t]``; the continuations then legitimately differ.
    Returns the index of the first mismatch, or None."""
    from repro_torch.models import lm
    assert len(got) == len(ref)
    for t, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        seq = np.concatenate([prompt, np.asarray(ref[:t], np.int32)])
        lg, _ = lm.prefill(params, torch.as_tensor(seq[None],
                                                   dtype=torch.long), cfg)
        lg = lg[0, -1].float()
        assert float(lg[a] - lg[b]) <= LOGIT_TOL, (t, a, b)
        return t
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_serves_the_single_process_tokens(engine_run, case):
    """Every request's tokens against the single-process engine's through
    the same plan, tie-aware: the data ranks' bf16 products round over
    fewer rows."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    got = dict(_ok(engine_run, case)[0]["finished"])
    ref = engine_run["refs"][case]
    want = dict(ref["finished"])
    cfg = get_config(CASES[case][0]).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid, toks in want.items():
        _tie_aware(params, cfg, prompts[rid], toks, got[rid])
    assert ref["committed"] == _ok(engine_run, case)[0]["committed"]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_completes_every_request_and_relayout(engine_run, case):
    """Every request complete with its max_new tokens, no block leaked,
    the one plan committed on every rank (staged, for a paged pool that
    keeps its block size), the pool placed after the relayout with its
    tensors kept, and the knobs the case exercises in use."""
    arch, _, _, extra, new = CASES[case]
    for res in _ok(engine_run, case):
        assert res["completed"] == res["requests"] == len(res["finished"])
        assert all(len(t) == 8 for _, t in res["finished"])
        assert res["live"] == 0
        assert {**res["setting"], **new} == res["setting"]
        assert [s for _, s in res["reconfigs"]] == [
            {**res["setting"], **new}]
        if res["tables"] is not None:
            snap = res["snapshot"]
            assert snap["blocks_held"] == snap["prefix_cached_blocks"]
            assert res["tables"].max() == 0
            assert res["reconfigs"][0][0], "the paged switch did not stage"
            assert res["shared_blocks_hit"] > 0
        if res["rank"] == 0:
            assert res["committed"] == [{**res["setting"], **new}]
            assert not res["abandoned"]
        else:
            assert res["committed"] == []
        if extra.get("spec_k"):
            assert res["spec_accepted"] >= 0


# =====================================================================
# (a) the JAX engine under single_device_meshspec(), 1x1
# =====================================================================

def _jax_parity(models, setting, check_pool=True):
    from repro.distributed.sharding import \
        single_device_meshspec as j_single
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.engine import serve_loop as j_serve_loop
    from repro_torch.distributed.sharding import single_device_meshspec
    from repro_torch.ps.stepfn import serve_param_specs
    from repro_torch.serving import Request, ServingEngine, serve_loop

    from _torch_port import tie_aware_check
    from test_torch_engine import _requests
    cfg, tcfg, jp, tp = models
    reqs = _requests(cfg.vocab_size)
    ms = single_device_meshspec()
    je = JEngine(jp, cfg, setting, max_seq=MAX_SEQ, ms=j_single())
    te = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu",
                       ms=ms, param_specs=serve_param_specs(tcfg, ms))
    j_stats = j_serve_loop(je, [JRequest(rid=i, prompt=p.copy(), max_new=n)
                                for i, p, n in reqs])
    t_stats = serve_loop(te, [Request(rid=i, prompt=p.copy(), max_new=n)
                              for i, p, n in reqs])
    assert t_stats["completed"] == j_stats["completed"] == len(reqs)
    for k in ("prefill_tokens_computed", "prefill_tokens_total",
              "shared_blocks_hit", "cow_copies"):
        assert t_stats[k] == j_stats[k], k
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for i, p, n in reqs:
        assert len(tout[i]) == n
        tie_aware_check(jp, cfg, p, jout[i], tout[i])
    if check_pool:
        te.pool.check_invariants()
        snap = te.pool.snapshot()
        assert snap["blocks_held"] == snap["prefix_cached_blocks"]
    return t_stats


@pytest.mark.parametrize("prefix_share", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_on_1x1_matches_jax_engine(prefix_share, quant):
    """Reduced starcoder2-3b: the JAX engine under
    ``single_device_meshspec()`` and the port's under its own (the fsdp
    specs of one device), tokens tie-aware and the prefill, sharing and
    copy-on-write counters equal."""
    from repro.serving.knobs import DEFAULT_SERVING_SETTING

    from _torch_port import dense_models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8,
                   prefix_share=prefix_share, quant=quant)
    stats = _jax_parity(dense_models(0), setting)
    if prefix_share:
        assert stats["shared_blocks_hit"] > 0 and stats["cow_copies"] > 0


def test_ssm_engine_on_1x1_matches_jax_engine():
    """Reduced falcon-mamba-7b under both packages' 1x1 meshes."""
    from repro.serving.knobs import DEFAULT_SERVING_SETTING

    from _torch_port import ssm_models
    _jax_parity(ssm_models(0), dict(DEFAULT_SERVING_SETTING, max_batch=4),
                check_pool=False)


# =====================================================================
# (b) the pools' placement, shape only
# =====================================================================

POOL_ARCHS = {"dense": "starcoder2-3b", "ssm": "falcon-mamba-7b",
              "hybrid": "zamba2-1.2b"}
POOL_MESHES = {"1x1": (1, 1), "2x2": (2, 2), "2x2x2": (2, 2, 2)}


def _meshspecs(shape):
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.distributed.sharding import MeshSpec as JMeshSpec
    from repro_torch.distributed.sharding import AbstractMesh, MeshSpec
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return (JMeshSpec(mesh=JAbstractMesh(shape, names), data_axes=names[:-1]),
            MeshSpec(mesh=AbstractMesh(shape, names), data_axes=names[:-1]))


def _pools(family):
    from repro.configs.registry import get_config as jget_config
    from repro.serving.knobs import DEFAULT_SERVING_SETTING
    from repro.serving.pool import make_state_pool as j_make_state_pool
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.pool import make_state_pool
    arch = POOL_ARCHS[family]
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8)
    jpool = j_make_state_pool(jget_config(arch).reduced(), setting, 32)
    pool = make_state_pool(get_config(arch).reduced(), setting, 32, "cpu")
    jstate = jpool.kv if family == "dense" else jpool.state
    state = pool.kv if family == "dense" else pool.state
    return jstate, state


@pytest.mark.parametrize("mesh", list(POOL_MESHES))
@pytest.mark.parametrize("family", list(POOL_ARCHS))
def test_pool_placement_matches_jax(family, mesh):
    """``param_specs`` of a pool's tensors and the specs of its
    ``param_shardings`` equal the JAX package's ``param_specs`` of its
    pool, leaf for leaf: every leaf whole on every mesh."""
    from jax.sharding import PartitionSpec

    from repro.distributed.sharding import param_specs as jparam_specs
    from repro_torch.core.tree import flatten
    from repro_torch.distributed.sharding import (Placement, param_shardings,
                                                  param_specs)
    jms, ms = _meshspecs(POOL_MESHES[mesh])
    jstate, state = _pools(family)
    want = {k: tuple(v) for k, v in jparam_specs(jstate, jms).items()}
    assert all(isinstance(v, PartitionSpec) for v in
               jparam_specs(jstate, jms).values())
    got = param_specs(state, ms)
    assert got == want
    assert all(s == (None,) * len(s) for s in got.values())
    placed = param_shardings(state, ms)
    paths, lv = flatten(placed)
    assert all(isinstance(p, Placement) and p.ms is ms for p in lv)
    assert dict(zip(paths, (p.spec for p in lv))) == want


@pytest.mark.parametrize("family", list(POOL_ARCHS))
def test_placing_a_pool_keeps_its_tensors(family):
    """``relocate_now`` of a pool to its placement (``pool.placed``) on a
    1x1 and a shape-only 2x2 mesh returns the very tensor objects: nothing
    is copied, so the steps captured on them stay bound."""
    from repro_torch.distributed.sharding import (AbstractMesh, MeshSpec,
                                                  single_device_meshspec)
    from repro_torch.serving.pool import placed
    _, state = _pools(family)
    ids = {k: id(t) for k, t in state.items()}
    for ms in (single_device_meshspec(),
               MeshSpec(mesh=AbstractMesh((2, 2), ("data", "model")),
                        data_axes=("data",))):
        state = placed(dict(state), ms)
        assert {k: id(t) for k, t in state.items()} == ids
    assert placed(state, None) is state


def test_pools_keep_their_placement_through_relayouts():
    """Under a 1x1 mesh a paged pool's stop-the-world relayout and staged
    commit, and an ssm pool's relayout, run ``placed`` on the new tensors
    (as the JAX pools' ``_place``) and keep them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import single_device_meshspec
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    from repro_torch.serving import pool as pool_mod
    ms = single_device_meshspec()
    calls = []
    real = pool_mod.placed

    def spy(state, m):
        out = real(state, m)
        calls.append((m, {k: id(t) for k, t in out.items()}))
        return out

    pool_mod.placed = spy
    try:
        setting = dict(DEFAULT_SERVING_SETTING, max_batch=2, block_size=8)
        paged = pool_mod.make_state_pool(
            get_config("starcoder2-3b").reduced(), setting, 32, "cpu", ms)
        paged.try_admit(np.arange(10, dtype=np.int32), 4)
        paged.relayout(dict(setting, max_batch=4), {0: (10, 14)})
        assert calls[-1] == (ms, {k: id(t) for k, t in paged.kv.items()})
        assert paged.begin_migration(dict(setting, max_batch=2))
        paged.finish_migration({0: (10, 14)})
        assert len(calls) == 2 and calls[-1][1] == {
            k: id(t) for k, t in paged.kv.items()}
        paged.check_invariants()
        ssm = pool_mod.make_state_pool(
            get_config("falcon-mamba-7b").reduced(), setting, 32, "cpu", ms)
        ssm.try_admit(np.arange(5, dtype=np.int32), 4)
        ssm.relayout(dict(setting, max_batch=3), {0: (5, 9)})
        assert len(calls) == 3 and calls[-1][1] == {
            k: id(t) for k, t in ssm.state.items()}
    finally:
        pool_mod.placed = real


def test_pool_decode_step_on_1x1_is_the_decode_step():
    """``build_pool_decode_step`` on a 1x1 mesh over a pool with live
    slots: the logits and every pool tensor of ``lm.decode_step`` with no
    mesh, bit for bit (every collective skipped at one device)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import single_device_meshspec
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.stepfn import build_pool_decode_step
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    from repro_torch.serving.pool import make_state_pool
    for arch in ("starcoder2-3b", "zamba2-1.2b"):
        cfg = get_config(arch).reduced()
        params = lm.init_params(cfg, 0, device="cpu")
        setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8)
        g = torch.Generator().manual_seed(3)
        outs = []
        for ms in (None, single_device_meshspec()):
            pool = make_state_pool(cfg, setting, 32, "cpu")
            for s in range(3):
                pool.try_admit(np.arange(9, dtype=np.int32), 6)
            state = pool.kv if pool.kind == "paged" else pool.state
            for t in state.values():
                t.copy_(torch.randn(t.shape, generator=g.manual_seed(3)))
            tok = torch.tensor([[5, 6], [7, 8], [9, 1], [2, 3]])
            pos = torch.tensor([9, 9, 9, 0], dtype=torch.int32)
            kn = ModelKnobs()
            if ms is None:
                lg, _ = lm.decode_step(params, pool.decode_cache(), tok, pos,
                                       cfg, kn)
            else:
                lg, _ = build_pool_decode_step(cfg, kn, ms)(
                    params, pool.decode_cache(), tok, pos)
            outs.append((lg, {k: t.clone() for k, t in state.items()}))
        assert torch.equal(outs[0][0], outs[1][0]), arch
        for k, t in outs[0][1].items():
            assert torch.equal(t, outs[1][1][k]), (arch, k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
