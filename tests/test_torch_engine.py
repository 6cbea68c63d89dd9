"""PyTorch port: the serving engine against the JAX package's engine on
the same parameters and requests, for prefix sharing on/off x int8 KV
on/off — greedy tokens equal (tie-aware), every request complete, no block
leaked."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.serving import Request, ServingEngine, serve_loop
from repro_torch.serving.workload import make_trace

from _torch_port import LOGIT_TOL, dense_models


@pytest.fixture(scope="module")
def models():
    return dense_models(0)


def _requests(vocab: int):
    """Two 16-token templates (two full blocks of 8) with short tails, one
    prompt that is a whole template (full match -> COW), one unrelated."""
    rng = np.random.default_rng(4)
    tpl = [rng.integers(0, vocab, (16,)).astype(np.int32) for _ in range(2)]
    prompts = [np.concatenate([tpl[i % 2],
                               rng.integers(0, vocab, (3 + i,))
                               .astype(np.int32)]) for i in range(4)]
    # admitted in the first tick, while request 0 still holds template 0
    prompts.insert(1, tpl[0].copy())
    prompts.append(rng.integers(0, vocab, (11,)).astype(np.int32))
    return [(i, p, 6) for i, p in enumerate(prompts)]


def _tie_aware_check(jp, cfg, prompt, ref_tokens, got_tokens):
    """Equal greedy tokens, except at an exact or near tie of the JAX
    model: at the first mismatch, the reference logits (JAX prefill over
    the prompt and the reference tokens so far) must rank the port's token
    within LOGIT_TOL of the reference's own; the continuations then
    legitimately differ and are not compared."""
    assert len(got_tokens) == len(ref_tokens)
    for t, (a, b) in enumerate(zip(ref_tokens, got_tokens)):
        if a == b:
            continue
        seq = np.concatenate([prompt, np.asarray(ref_tokens[:t], np.int32)])
        lg, _ = jlm.prefill(jp, {"tokens": jnp.asarray(seq[None])}, cfg)
        lg = np.asarray(lg[0, -1], np.float32)
        assert lg[a] - lg[b] <= LOGIT_TOL, (
            f"token {t}: reference {a} ({lg[a]}) vs port {b} ({lg[b]})")
        return t
    return None


@pytest.mark.parametrize("prefix_share", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_tokens_match_jax_engine(models, prefix_share, quant):
    cfg, tcfg, jp, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8,
                   prefix_share=prefix_share, quant=quant)
    reqs = _requests(cfg.vocab_size)
    je = JEngine(jp, cfg, setting, max_seq=48)
    te = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu")
    j_stats = j_serve_loop(je, [JRequest(rid=i, prompt=p.copy(), max_new=n)
                                for i, p, n in reqs])
    t_stats = serve_loop(te, [Request(rid=i, prompt=p.copy(), max_new=n)
                              for i, p, n in reqs])
    assert t_stats["completed"] == j_stats["completed"] == len(reqs)
    for k in ("prefill_tokens_computed", "prefill_tokens_total",
              "shared_blocks_hit", "cow_copies"):
        assert t_stats[k] == j_stats[k], k
    if prefix_share:
        assert t_stats["shared_blocks_hit"] > 0 and t_stats["cow_copies"] > 0
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for i, p, n in reqs:
        assert len(tout[i]) == n
        _tie_aware_check(jp, cfg, p, jout[i], tout[i])
    te.pool.check_invariants()
    assert te.pool.n_active == 0
    snap = te.pool.snapshot()
    assert snap["blocks_held"] == snap["prefix_cached_blocks"]   # no leak
    assert te.pool.tables.max() == 0


def test_engine_serves_a_generated_trace(models):
    """serve_loop over a shared-prefix trace from the port's own workload
    generator: every request completes with its max_new tokens, stats
    are consistent, and the executable cache reuses its callables."""
    _, tcfg, _, tp = models
    trace = make_trace("shared_prefix", 200.0, 0.05, vocab=tcfg.vocab_size,
                       seed=1, prefix_len=16, tail_lens=(2, 6),
                       max_news=(3, 5))
    assert all(isinstance(r, Request) for r in trace) and len(trace) >= 4
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8,
                   prefix_share=True, cache_dtype="bf16")
    eng = ServingEngine(tp, tcfg, setting, max_seq=48, device="cpu")
    eng.warm_start(max_prompt=24)
    warmed = len(eng._steps)
    stats = serve_loop(eng, trace)
    assert stats["completed"] == stats["requests"] == len(trace)
    assert all(len(r.tokens_out) == r.max_new for r in eng.finished)
    assert stats["tokens"] == sum(r.max_new for r in trace)
    assert stats["prefill_tokens_computed"] < stats["prefill_tokens_total"]
    assert stats["exec_cache"]["hits"] > 0 and len(eng._steps) == warmed
    assert eng.pool.kv["k"].dtype == torch.bfloat16
    eng.pool.check_invariants()
