"""PyTorch port: what the captured steps rely on, on the CPU — the prefill
with ``last_idx`` / ``valid_len`` as device tensors (one graph a bucket)
against the int path and the JAX engine's ``_prefill_exec``, the pool's
persistent block table, the replay launch accounting of ``GraphStep``
(with a stub graph: capture and replay need the card), and the graphs a
replaced pool takes with it."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import ServingEngine as JEngine
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.core import lru
from repro_torch.core.lru import GraphStep, aot_compile
from repro_torch.kernels import LAUNCHES
from repro_torch.models import lm
from repro_torch.serving import ServingEngine
from repro_torch.serving.pool import PagedKVPool, make_state_pool

from _torch_port import LOGIT_TOL, dense_models, f32, ssm_models

BUCKET = 16


@pytest.fixture(scope="module", params=["dense", "ssm"])
def models(request):
    return (dense_models if request.param == "dense" else ssm_models)(0)


def test_prefill_last_idx_tensor_equals_int_path_and_jax(models):
    """At every last_idx of a bucket: the engine's prefill step (last_idx
    and valid_len as (1,) int64 tensors, the logits row by index_select)
    equals the int path (an int valid_len, the row by slicing) bit for bit
    — logits and the returned cache — and the JAX engine's _prefill_exec
    within LOGIT_TOL (the bf16 rounding bound of _torch_port)."""
    cfg, tcfg, jp, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=2, block_size=8)
    te = ServingEngine(tp, tcfg, setting, max_seq=32, device="cpu")
    je = JEngine(jp, cfg, setting, max_seq=32)
    step, jstep = te._prefill_exec(BUCKET), je._prefill_exec(BUCKET)
    rng = np.random.default_rng(5)
    tokens = np.zeros((1, BUCKET), np.int64)
    for last in range(BUCKET):
        tokens[0, :last + 1] = rng.integers(0, cfg.vocab_size, last + 1)
        tokens[0, last + 1:] = 0
        tt = torch.from_numpy(tokens)
        logits, cache = step(tp, tt, torch.tensor([last]))
        hidden, icache = lm.forward(tp, tt, tcfg, mode="prefill",
                                    valid_len=last + 1)
        ilogits = lm.logits_fn(tp, hidden[:, last:last + 1], tcfg)[:, 0]
        assert torch.equal(logits, ilogits), last
        for k in cache:
            assert torch.equal(cache[k], icache[k]), (last, k)
        jl, jc = jstep(jp, jnp.asarray(tokens, jnp.int32),
                       jnp.asarray(last, jnp.int32))
        np.testing.assert_allclose(f32(logits), f32(jl), atol=LOGIT_TOL,
                                   rtol=0)
        if tcfg.family == "ssm":
            # the state after token last: conv window exactly the inputs'
            # bf16 values, h within the same bound
            for k in ("conv", "h"):
                np.testing.assert_allclose(f32(cache[k]), f32(jc[k]),
                                           atol=LOGIT_TOL, rtol=0)


def test_pool_device_table_follows_host_tables():
    """The block table the decode step reads is one tensor for the pool's
    life, and after admission, copy-on-write and release it equals
    ``torch.as_tensor(pool.tables)``."""
    _, tcfg, _, _ = dense_models(0)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3, block_size=8,
                   prefix_share=True)
    pool = PagedKVPool(tcfg, setting, 48, "cpu")
    table = pool.decode_cache()["block_tables"]
    assert table is pool.dev_tables and table.dtype == torch.int32

    def same():
        bt = pool.decode_cache()["block_tables"]
        assert bt is table
        assert torch.equal(bt, torch.as_tensor(pool.tables))

    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 200, 16).astype(np.int32)
    slot0, _ = pool.try_admit(prompt, 8)
    same()
    slot1, shared = pool.try_admit(prompt.copy(), 8)   # full match
    assert shared == 15
    same()
    pool.prepare_write(slot1, shared, 16)              # COW
    assert pool.cow_copies == 1
    same()
    recs = pool.prepare_spec_write(slot0, 8, 12)       # deferred COW
    same()
    pool.commit_spec_write(slot0, recs, 8)             # rejected: undone
    same()
    pool.release(slot0)
    same()
    pool.release(slot1)
    same()
    pool.check_invariants()
    assert int(table.abs().sum()) == 0


@pytest.fixture
def stub_graph(monkeypatch):
    """Capture and replay need the card: a graph that records its replays,
    streams that do nothing, and a capture that runs the step eagerly."""
    class Stream:
        def __init__(self, *_):
            pass

        def wait_stream(self, _):
            pass

    class Graph:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    monkeypatch.setattr(lru, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *_, **__: contextlib.nullcontext())


def test_graph_step_counts_launches_per_replay(stub_graph):
    """A capture records how much each launch counter rose and takes it
    back (capture launches nothing); every replay adds it again.  The
    warm-up runs on zero tensors in place of the state; inputs are copied
    into static buffers; a call with other state tensors is refused."""
    seen = []

    def fn(params, state, x):
        seen.append(state["h"])
        LAUNCHES["paged_attention"] += 2
        LAUNCHES["selective_scan"] += 1
        return x * params["w"]

    params = {"w": torch.full((4,), 3.0)}
    state = {"h": torch.ones(2, 4)}
    before = dict(LAUNCHES)
    step = GraphStep(fn, params, state, torch.zeros(4), inputs=(2,),
                     state=(1,))
    # the warm-up ran (and launched); the capture's counts were taken back
    assert LAUNCHES["paged_attention"] == before["paged_attention"] + 2
    assert LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    assert step.launches == {"paged_attention": 2, "selective_scan": 1}
    assert seen[0] is not state["h"] and not seen[0].any()
    assert seen[1] is state["h"]
    for i in range(3):
        out = step(params, state, torch.arange(4.0) + i)
    assert step.graph.replays == 3 and out is step.out
    assert torch.equal(step._static[2], torch.arange(4.0) + 2)
    assert LAUNCHES["paged_attention"] == before["paged_attention"] + 8
    assert LAUNCHES["selective_scan"] == before["selective_scan"] + 4
    with pytest.raises(ValueError, match="not the tensors"):
        step(params, {"h": torch.ones(2, 4)}, torch.zeros(4))
    assert step.eager is fn
    assert aot_compile(fn, params, state, torch.zeros(4),
                       device="cpu") is fn


def test_pool_replacement_drops_its_steps(models):
    """The graphs of the decode, suffix-prefill and replay steps hold the
    pool's tensors by address: adopting a new pool drops them, and keeps
    the prefill and quant steps, which capture no pool tensor."""
    _, tcfg, _, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=2, block_size=8,
                   prefix_share=True, quant="int8")
    eng = ServingEngine(tp, tcfg, setting, max_seq=32, device="cpu")
    eng._decode_exec(0)
    eng._decode_exec(0, 3)
    eng._prefill_exec(BUCKET)
    eng._quant_exec(BUCKET)
    if eng.pool.kind == "paged":
        eng._chunk_prefill_exec(BUCKET)
    else:
        eng.pool.save_state()
        eng._replay_exec(2)
    kept = {("prefill", BUCKET, setting["k_chunk"]), ("quant", BUCKET)}
    assert kept < set(eng._steps._d) and len(eng._steps) == 5
    old = eng.pool
    eng._set_pool(make_state_pool(tcfg, eng.setting, 32, "cpu"))
    assert eng.pool is not old and set(eng._steps._d) == kept
