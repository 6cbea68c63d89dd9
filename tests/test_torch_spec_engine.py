"""PyTorch port: speculative decoding in the serving engine, held to the
port's own plain greedy (``spec_k = 0``) engine — the properties of
``tests/test_spec_decode.py`` — and to the JAX engine serving the same
requests with the same scripted drafter.

The scripted drafter forces every accept pattern (full accept, full
reject, arbitrary per position), so the paged pools' deferred
copy-on-write records and the ssm pools' snapshot-and-replay rollback run
at every accepted length.  Property tests set ``deadline=None`` (ROADMAP
C3)."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # offline shim: same API, fixed-seed examples
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro_torch.serving import (DEFAULT_SERVING_SETTING, Request,
                                 ServingEngine, serve_loop)

from _torch_port import dense_models, ssm_models, tie_aware_check

MAX_SEQ = 48
_MODELS: dict = {}


def _models(family):
    if family not in _MODELS:
        _MODELS[family] = (dense_models if family == "dense"
                           else ssm_models)(0)
    return _MODELS[family]


def _requests(vocab, seed=3, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, vocab, (p,)).astype(np.int32),
                max_new=m, arrival_s=0.0)
            for i, (p, m) in enumerate([(6, 9), (11, 5), (4, 12)])]


class ScriptedDrafter:
    """Drafter whose per-position accept/reject outcome is scripted (the
    JAX test's): where ``pattern`` says 1 it proposes the reference greedy
    token, where 0 that token + 1 (mod vocab), which the target rejects."""

    name = "scripted"

    def __init__(self, refs, pattern, vocab):
        self.refs = refs
        self.pattern = list(pattern) or [0]
        self.vocab = int(vocab)
        self._slots: dict = {}

    def update(self, slot, rid, prompt, tokens_out):
        self._slots[slot] = (rid, len(tokens_out))

    def propose(self, slot, k):
        rid, done = self._slots[slot]
        ref = self.refs[rid]
        out = np.empty(k, np.int32)
        for j in range(k):
            p = done + j
            t = ref[p] if p < len(ref) else (ref[-1] if ref else 0)
            if not (p < len(ref) and self.pattern[p % len(self.pattern)]):
                t = (t + 1) % self.vocab
            out[j] = t
        return out

    def release(self, slot):
        self._slots.pop(slot, None)


def _run(family, k, setting, drafter=None, attn_impl="paged"):
    _, tcfg, _, tp = _models(family)
    eng = ServingEngine(tp, tcfg, dict(setting, spec_k=float(k)),
                        max_seq=MAX_SEQ, attn_impl=attn_impl, device="cpu")
    if drafter is not None:
        eng._drafters[eng.setting["drafter"]] = drafter
    reqs = _requests(tcfg.vocab_size)
    stats = serve_loop(eng, reqs)
    assert stats["completed"] == len(reqs)
    return {r.rid: list(r.tokens_out) for r in eng.finished}, eng, stats


def _assert_no_leaks(pool):
    if pool.kind != "paged":
        assert not any(pool.slot_live)
        return
    pool.check_invariants()
    assert int(pool.ref[1:].sum()) == 0


CASES = (
    ("dense", "paged", {}),
    ("dense", "paged", {"quant": "int8"}),
    ("dense", "gather", {}),
    ("ssm", "paged", {}),          # ssm ignores attn_impl (no KV blocks)
)
_REFS: dict = {}


def _reference(case_idx):
    """The port's plain greedy output (spec_k = 0) of the same engine."""
    if case_idx not in _REFS:
        family, impl, extra = CASES[case_idx]
        outs, eng, _ = _run(family, 0, dict(DEFAULT_SERVING_SETTING,
                                            max_batch=3, **extra),
                            attn_impl=impl)
        _assert_no_leaks(eng.pool)
        _REFS[case_idx] = outs
    return _REFS[case_idx]


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=12),
       st.integers(1, 4), st.integers(0, len(CASES) - 1))
def test_spec_parity_arbitrary_accept_patterns(pattern, k, case_idx):
    """Whatever prefix the scripted drafter makes the verify step accept
    (0..k a tick, varying per slot and tick), the served tokens equal the
    plain greedy engine's and the pool ends with nothing held."""
    family, impl, extra = CASES[case_idx]
    refs = _reference(case_idx)
    vocab = _models(family)[1].vocab_size
    outs, eng, stats = _run(family, k, dict(DEFAULT_SERVING_SETTING,
                                            max_batch=3, **extra),
                            ScriptedDrafter(refs, pattern, vocab),
                            attn_impl=impl)
    assert outs == refs, (family, impl, extra, k, pattern)
    assert eng.spec_ticks > 0 and 0 <= eng.spec_accepted <= eng.spec_drafted
    assert stats["speculation"]["drafted"] == eng.spec_drafted
    _assert_no_leaks(eng.pool)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_full_accept_and_reject_extremes(family):
    """An always-right drafter commits k+1 tokens a tick, an always-wrong
    one none of its drafts; both serve the greedy tokens.  For ssm the
    wrong one rolls every slot back by replay on every tick."""
    case = 0 if family == "dense" else 3
    refs = _reference(case)
    vocab = _models(family)[1].vocab_size
    for pattern in ([1], [0]):
        outs, eng, _ = _run(family, 3, dict(DEFAULT_SERVING_SETTING,
                                            max_batch=3),
                            ScriptedDrafter(refs, pattern, vocab))
        assert outs == refs, pattern
        _assert_no_leaks(eng.pool)
        if pattern == [1]:
            assert eng.spec_accepted > 0
    assert eng.spec_accepted == 0


def test_adversarial_drafter_over_shared_prefixes():
    """A 0%-accept drafter over copy-on-write-shared prefixes: the pool
    passes check_invariants after every tick, the cached prefix blocks keep
    their rows, and the tokens are the greedy ones."""
    _, tcfg, _, tp = _models("dense")
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, prefix_share=True,
                   block_size=8)
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, tcfg.vocab_size, (17,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, tcfg.vocab_size,
                                                    (2 + i,)).astype(np.int32)])
               for i in range(6)]
    ref_eng = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    serve_loop(ref_eng, [Request(rid=i, prompt=p.copy(), max_new=8)
                         for i, p in enumerate(prompts)])
    refs = {r.rid: list(r.tokens_out) for r in ref_eng.finished}
    eng = ServingEngine(tp, tcfg, dict(setting, spec_k=3.0),
                        max_seq=MAX_SEQ, device="cpu")
    eng._drafters["ngram"] = ScriptedDrafter(refs, [0], tcfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=8), now=0.0)
    ticks, witness = 0, None
    while eng.has_work():
        eng.step(now=ticks * 0.01)
        eng.pool.check_invariants()
        if witness is None and eng.pool.block_key:
            blocks = sorted(eng.pool.block_key)
            witness = (blocks, eng.pool.kv["k"][:, blocks].clone())
        ticks += 1
        assert ticks < 400
    assert {r.rid: list(r.tokens_out) for r in eng.finished} == refs
    assert eng.spec_accepted == 0 and eng.spec_ticks > 0
    blocks, before = witness
    kept = [i for i, b in enumerate(blocks) if b in eng.pool.block_key]
    assert kept
    after = eng.pool.kv["k"][:, [blocks[i] for i in kept]]
    assert bool((before[:, kept] == after).all())
    _assert_no_leaks(eng.pool)


@pytest.mark.parametrize("family,k,pattern", [
    ("dense", 3, [1, 0, 1, 1, 0]), ("ssm", 2, [1, 1, 0])])
def test_spec_tokens_match_jax_engine(family, k, pattern):
    """The JAX engine and the port, both speculating with the same
    scripted drafter (built on the JAX engine's greedy tokens): every
    request complete with the same accounting, and the tokens equal
    (tie-aware, as the port's greedy tokens are held to JAX's)."""
    cfg, tcfg, jp, tp = _models(family)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3)
    je0 = JEngine(jp, cfg, setting, max_seq=MAX_SEQ)
    j_serve_loop(je0, _requests(cfg.vocab_size, cls=JRequest))
    refs = {r.rid: list(r.tokens_out) for r in je0.finished}
    je = JEngine(jp, cfg, dict(setting, spec_k=float(k)), max_seq=MAX_SEQ)
    je.async_precompile = False
    je._drafters["ngram"] = ScriptedDrafter(refs, pattern, cfg.vocab_size)
    j_serve_loop(je, _requests(cfg.vocab_size, cls=JRequest))
    touts, te, stats = _run(family, k, setting,
                            ScriptedDrafter(refs, pattern, tcfg.vocab_size))
    jouts = {r.rid: list(r.tokens_out) for r in je.finished}
    assert jouts == refs
    diverged = False
    for r in _requests(cfg.vocab_size):
        assert len(touts[r.rid]) == r.max_new
        diverged |= tie_aware_check(jp, cfg, r.prompt, jouts[r.rid],
                                    touts[r.rid]) is not None
    if not diverged:        # the same tokens drafted: the same verdicts
        assert (te.spec_drafted, te.spec_accepted, te.spec_ticks) == (
            je.spec_drafted, je.spec_accepted, je.spec_ticks)
    assert stats["speculation"]["spec_k"] == k
    _assert_no_leaks(te.pool)


@pytest.mark.parametrize("family,drafter", [("dense", "ngram"),
                                            ("ssm", "truncated")])
def test_real_drafters_serve_greedy_tokens(family, drafter):
    """The port's own drafters (what chip_smoke serves with) speculate
    without changing a served token."""
    refs = _reference(0 if family == "dense" else 3)
    outs, eng, stats = _run(family, 2, dict(DEFAULT_SERVING_SETTING,
                                            max_batch=3, drafter=drafter))
    assert outs == refs
    assert stats["speculation"]["drafter"] == drafter
    assert eng.spec_ticks > 0
    _assert_no_leaks(eng.pool)
