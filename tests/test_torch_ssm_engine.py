"""PyTorch port, ssm family in the serving engine: reduced falcon-mamba
served by the port's engine against the JAX package's engine on the same
parameters and requests (greedy tokens equal, tie-aware), the recurrent
state pool's admission and release, and the engine's metrics on a pool
without blocks."""
import numpy as np
import pytest
import torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.launch import serve as launch_serve
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import Request, ServingEngine, serve_loop
from repro_torch.serving.pool import SSMStatePool, make_state_pool
from repro_torch.serving.workload import make_trace

from _torch_port import ssm_models, tie_aware_check


@pytest.fixture(scope="module")
def models():
    return ssm_models(0)


def _requests(vocab: int):
    """Prompts of 1-20 tokens: shorter than the conv window, inside one
    prefill bucket, and across two; more requests than slots."""
    rng = np.random.default_rng(7)
    lens = [1, 2, 3, 9, 16, 20, 5]
    return [(i, rng.integers(0, vocab, (n,)).astype(np.int32), 3 + i % 4)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("cache_dtype", ["bf16", "f32"])
def test_ssm_engine_tokens_match_jax_engine(models, cache_dtype):
    cfg, tcfg, jp, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4,
                   cache_dtype=cache_dtype)
    reqs = _requests(cfg.vocab_size)
    je = JEngine(jp, cfg, setting, max_seq=48)
    te = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu")
    assert te.pool.kind == je.pool.kind == "ssm"
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
    assert te.pool.n_active == 0
    assert te.pool.state["h"].dtype == torch.float32
    assert te.pool.state["conv"].dtype == (torch.bfloat16
                                           if cache_dtype == "bf16"
                                           else torch.float32)


def test_ssm_engine_ignores_quant_and_prefix_share(models):
    """int8 and prefix sharing apply to paged pools only: an ssm engine
    with both on serves the same tokens and prefills every prompt
    token, as the JAX engine does."""
    _, tcfg, _, tp = models
    reqs = _requests(tcfg.vocab_size)
    outs = []
    for extra in ({}, {"quant": "int8", "prefix_share": True}):
        setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, **extra)
        eng = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu")
        eng.warm_start(max_prompt=20)
        assert not any(k[0] == "chunkpf" for k in eng._steps._d)
        stats = serve_loop(eng, [Request(rid=i, prompt=p.copy(), max_new=n)
                                 for i, p, n in reqs])
        assert stats["prefill_tokens_computed"] == stats[
            "prefill_tokens_total"]
        outs.append({r.rid: r.tokens_out for r in eng.finished})
    assert outs[0] == outs[1]


def test_ssm_pool_admission_and_release(models):
    _, tcfg, _, _ = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3, cache_dtype="bf16")
    pool = make_state_pool(tcfg, setting, 48, "cpu")
    assert isinstance(pool, SSMStatePool)
    assert pool.exec_key() == ("ssm", 3, "bf16")
    L, Di, N, K = tcfg.n_layers, tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_conv
    assert tuple(pool.state["h"].shape) == (L, 3, Di, N)
    assert tuple(pool.state["conv"].shape) == (L, 3, Di, K - 1)
    prompt = np.arange(40, dtype=np.int32)       # any length: O(1) state
    assert [pool.try_admit(prompt, 8) for _ in range(3)] == [
        (0, 0), (1, 0), (2, 0)]
    assert pool.try_admit(prompt, 8) is None and pool.n_active == 3
    pool.release(1)
    assert pool.n_active == 2 and pool.try_admit(prompt, 8) == (1, 0)
    pc = {"conv": torch.full((L, 1, Di, K - 1), 0.5, dtype=torch.float32),
          "h": torch.full((L, 1, Di, N), 0.25, dtype=torch.float32)}
    pool.write_prefill(2, pc, 40)
    assert pool.state["conv"].dtype == torch.bfloat16
    assert bool((pool.state["conv"][:, 2] == 0.5).all())
    assert bool((pool.state["h"][:, 2] == 0.25).all())
    assert not pool.state["h"][:, :2].any()          # other slots untouched
    cache = pool.decode_cache()
    assert cache["h"] is pool.state["h"]             # decode writes in place
    pool.set_cache({"conv": cache["conv"].float(), "h": cache["h"]})
    assert pool.state["conv"].dtype == torch.bfloat16     # pinned
    pool.prepare_step_writes([0, 1, 2], np.zeros(3, np.int32))
    snap = pool.snapshot()
    assert snap["kind"] == "ssm" and snap["live_slots"] == 3
    assert "block_utilization" not in snap
    for s in range(3):
        pool.release(s)
    assert pool.n_active == 0


def test_ssm_engine_with_live_metrics(models):
    """A live MetricsRegistry on an ssm engine: the pool has no blocks,
    so the tick sets the slot and queue gauges and no block-utilization
    gauge (the engine read that key from every pool before)."""
    _, tcfg, _, tp = models
    metrics = MetricsRegistry()
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=2)
    eng = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu",
                        metrics=metrics)
    stats = serve_loop(eng, [Request(rid=i, prompt=p.copy(), max_new=n)
                             for i, p, n in _requests(tcfg.vocab_size)[:3]])
    assert stats["completed"] == 3
    snap = metrics.snapshot()
    assert "serve.active_slots" in snap["gauges"]
    assert "pool.block_utilization" not in snap["gauges"]
    assert snap["histograms"]["serve.tick_s"]["count"] > 0


def test_ssm_engine_serves_a_generated_trace(models):
    """serve_loop over a mixed-lengths trace from the port's generator:
    every request completes with its max_new tokens, no slot stays live,
    and the warmed callables are reused."""
    _, tcfg, _, tp = models
    trace = make_trace("mixed_lengths", 200.0, 0.05, vocab=tcfg.vocab_size,
                       seed=3, short_lens=(2, 8), long_lens=(20, 30),
                       max_news=(2, 5))
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3)
    eng = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu")
    eng.warm_start(max_prompt=30)
    warmed = len(eng._steps)
    stats = serve_loop(eng, trace)
    assert stats["completed"] == stats["requests"] == len(trace) >= 4
    assert all(len(r.tokens_out) == r.max_new for r in eng.finished)
    assert eng.pool.n_active == 0 and not any(eng.pool.slot_live)
    assert stats["exec_cache"]["hits"] > 0 and len(eng._steps) == warmed


def test_launcher_serves_falcon_mamba_on_cpu(capsys):
    launch_serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                       "cpu", "--rate", "40", "--duration", "0.2",
                       "--gen", "4", "--scenario", "mixed_lengths"])
    out = capsys.readouterr().out
    assert "family=ssm" in out and out.rstrip().endswith("OK")
