"""PyTorch port: the drafters of speculative decoding against the JAX
package's on the same parameters and traffic — the n-gram drafter's
proposals equal (the same numpy code and generator), the truncated
drafter's equal except where the JAX draft model's top two logits tie
exactly (ROADMAP C1)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import lm as jlm
from repro.serving.drafter import Drafter as JDrafter
from repro.serving.drafter import NgramDrafter as JNgram
from repro.serving.drafter import TruncatedDrafter as JTruncated
from repro_torch.serving.drafter import (Drafter, NgramDrafter,
                                         TruncatedDrafter, make_drafter)

from _torch_port import dense_models, ssm_models


def _traffic(vocab: int, seed: int):
    """(slot, rid, prompt, tokens_out) syncs of three requests over two
    slots, the second request repeating part of the first (corpus hits)
    and a reused slot."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, 12).astype(np.int32)
    b = np.concatenate([a[3:9], rng.integers(0, vocab, 3).astype(np.int32)])
    c = rng.integers(0, vocab, 5).astype(np.int32)
    out_a = list(rng.integers(0, vocab, 4))
    return [(0, 0, a, []), (1, 1, b, []), (0, 0, a, out_a[:2]),
            (1, 1, b, [int(a[9])]), (0, 0, a, out_a), (0, 2, c, []),
            (1, 1, b, [int(a[9]), int(a[10])])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_drafter_matches_jax(seed):
    vocab = 64
    jd, td = JNgram(vocab, seed=seed), NgramDrafter(vocab, seed=seed)
    for slot, rid, prompt, out in _traffic(vocab, seed):
        jd.update(slot, rid, prompt, out)
        td.update(slot, rid, prompt, out)
        for k in (1, 3, 4):
            np.testing.assert_array_equal(td.propose(slot, k),
                                          jd.propose(slot, k))
    jd.release(0)
    td.release(0)
    np.testing.assert_array_equal(td.propose(0, 3), jd.propose(0, 3))
    assert make_drafter("ngram", None, None, vocab=vocab).name == "ngram"


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_truncated_drafter_matches_jax(family):
    """Half the layers (1 of the reduced model's 2) over a right-padded
    window of 16.  The port runs it as a prefill with a device valid_len,
    the JAX drafter as a train-mode forward: the same causal function in
    other bf16 roundings, so a proposal may differ only where the JAX
    draft model's top two logits are equal."""
    cfg, tcfg, jp, tp = (dense_models if family == "dense"
                         else ssm_models)(0)
    jd = JTruncated(jp, cfg, vocab=cfg.vocab_size)
    td = make_drafter("truncated", tp, tcfg, vocab=tcfg.vocab_size,
                      device="cpu")
    assert isinstance(td, TruncatedDrafter) and td.cfg.n_layers == 1
    compared = ties = 0
    for slot, rid, prompt, out in _traffic(cfg.vocab_size, 7):
        jd.update(slot, rid, prompt, out)
        td.update(slot, rid, prompt, out)
        k = 4
        ctx = list(td._slot_ctx[slot])
        got, want = td.propose(slot, k), jd.propose(slot, k)
        for j in range(k):
            compared += 1
            if got[j] == want[j]:
                continue
            tail = (ctx + [int(t) for t in want[:j]])[-16:]
            toks = np.zeros((1, 16), np.int32)
            toks[0, :len(tail)] = tail
            hidden, _, _ = jlm.forward(jd.params, {"tokens":
                                                   jnp.asarray(toks)},
                                       jd.cfg, None, mode="train")
            row = np.asarray(jlm.logits_fn(jd.params, hidden, jd.cfg,
                                           None)[0, len(tail) - 1],
                             np.float32)
            assert row[got[j]] == row.max() == row[want[j]], (
                f"slot {slot} draft {j}: port {got[j]} vs JAX {want[j]} "
                f"without a tie ({row[got[j]]} vs {row.max()})")
            ties += 1
            break                   # the continuations legitimately differ
    assert compared >= 20 and ties <= 1


@pytest.mark.parametrize("name", ["ngram", "truncated"])
def test_drafters_satisfy_the_protocol(name):
    """Both drafters are ``Drafter``s (``runtime_checkable``: ``name``,
    ``update``, ``propose``, ``release``), as the JAX package's are its
    ``Drafter``s; an object without ``propose`` is not one."""
    cfg, tcfg, jp, tp = dense_models(0)
    d = make_drafter(name, tp, tcfg, vocab=tcfg.vocab_size, device="cpu")
    assert isinstance(d, Drafter) and d.name == name
    j = (JNgram(cfg.vocab_size) if name == "ngram"
         else JTruncated(jp, cfg, vocab=cfg.vocab_size))
    assert isinstance(j, JDrafter)
    members = {m for m in dir(Drafter) if not m.startswith("_")}
    assert members == {m for m in dir(JDrafter) if not m.startswith("_")}

    class NoPropose:
        name = "none"

        def update(self, slot, rid, prompt, tokens_out):
            pass

        def release(self, slot):
            pass
    assert not isinstance(NoPropose(), Drafter)
