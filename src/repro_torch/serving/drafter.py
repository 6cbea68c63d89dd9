"""Draft-token proposers for speculative decoding: the port of the JAX
package's ``serving/drafter.py``.

A drafter (``Drafter``, the protocol the engine needs) proposes ``k``
cheap continuation tokens per live slot; the engine verifies all of them in ONE multi-token decode step against the
target model and rolls the rejected tail back.  Drafters keep only host
token histories (and the truncated one its own captured step), never the
engine's pool state, so the ``drafter`` knob is a Type II policy swap.

Both are greedy: the verified output is token for token the plain greedy
output whatever the drafter proposes; a bad drafter only costs
speculation efficiency.

  * ``NgramDrafter``: prompt-lookup decoding over every token the engine
    has seen, longest suffix match first; misses draw from a seeded
    ``numpy`` generator.  The JAX package's numpy code, unchanged, so it
    proposes the same tokens for the same seed and traffic.
  * ``TruncatedDrafter``: the target's own bottom ``n_layers // 2`` layers,
    final norm and lm head, run greedily over a right-padded window of the
    last 16 context tokens.  The JAX drafter runs its causal forward in
    ``mode="train"``; the port has no training mode yet and runs the same
    causal function as ``mode="prefill"`` with a device ``valid_len``
    (flash attention for the dense family, the scan from zeros for ssm).
    Its shape is fixed, so on the card it is one captured graph.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.lru import aot_compile
from repro_torch.device import Staging
from repro_torch.models import lm


@runtime_checkable
class Drafter(Protocol):
    """What the engine needs from a draft-token proposer (the JAX
    package's protocol).  ``update`` is idempotent per (slot, rid,
    progress): the engine calls it every speculative tick with the slot's
    whole request context and the drafter takes only what it has not
    seen, so a drafter swapped in mid-run, or handed a reused slot,
    resyncs itself."""

    name: str

    def update(self, slot: int, rid, prompt: np.ndarray,
               tokens_out: list) -> None:
        """Sync the slot's context: ``prompt`` + committed ``tokens_out``."""
        ...

    def propose(self, slot: int, k: int) -> np.ndarray:
        """Return exactly ``k`` draft tokens (int32) for the slot."""
        ...

    def release(self, slot: int) -> None:
        """The slot's request finished; drop per-slot state."""
        ...


class _SlotContexts:
    """Each slot's context: its prompt and committed tokens.  ``update``
    is idempotent per (slot, rid, progress): the engine calls it every
    speculative tick with the slot's whole request, and only what was not
    seen yet is taken (and handed to ``_absorb``)."""

    def __init__(self):
        self._slot_rid: dict[int, object] = {}
        self._slot_seen: dict[int, int] = {}     # tokens_out consumed
        self._slot_ctx: dict[int, list[int]] = {}

    def _absorb(self, toks):
        pass

    def update(self, slot, rid, prompt, tokens_out):
        if self._slot_rid.get(slot) != rid:
            self._slot_rid[slot] = rid
            self._slot_seen[slot] = 0
            self._slot_ctx[slot] = [int(t) for t in prompt]
            self._absorb(prompt)
        new = tokens_out[self._slot_seen[slot]:]
        if new:
            self._slot_seen[slot] = len(tokens_out)
            self._slot_ctx[slot].extend(int(t) for t in new)
            self._absorb(new)

    def release(self, slot):
        self._slot_rid.pop(slot, None)
        self._slot_seen.pop(slot, None)
        self._slot_ctx.pop(slot, None)


class NgramDrafter(_SlotContexts):
    """Prompt-lookup drafting over a cross-request token corpus.

    Every synced token is appended to one global corpus; an index maps each
    trailing n-gram (n = 3, then 2 as fallback) to the corpus position
    *after* its most recent occurrence.  ``propose`` chains k lookups,
    feeding each proposal back as context — one corpus match can yield a
    whole accepted run.  Lookup misses draw from a seeded RNG so results
    are deterministic for a fixed (seed, traffic) pair.
    """

    name = "ngram"
    NS = (3, 2)                       # longest-suffix-match first

    def __init__(self, vocab: int, seed: int = 0):
        super().__init__()
        self.vocab = int(vocab)
        self._rng = np.random.default_rng(seed)
        self._corpus: list[int] = []
        self._index: dict[int, dict[tuple, int]] = {n: {} for n in self.NS}

    def _absorb(self, toks):
        corpus = self._corpus
        for t in toks:
            corpus.append(int(t))
            i = len(corpus)                      # position after the token
            for n in self.NS:
                if i >= n:
                    self._index[n][tuple(corpus[i - n:i])] = i

    def propose(self, slot, k):
        """Exactly ``k`` draft tokens (int32) for the slot."""
        ctx = list(self._slot_ctx.get(slot, ()))
        corpus = self._corpus
        out = np.empty(k, np.int32)
        for j in range(k):
            tok = None
            for n in self.NS:
                if len(ctx) < n:
                    continue
                p = self._index[n].get(tuple(ctx[-n:]))
                if p is not None and p < len(corpus):
                    tok = corpus[p]
                    break
            if tok is None:
                tok = int(self._rng.integers(0, self.vocab))
            out[j] = tok
            ctx.append(tok)
        return out


class TruncatedDrafter(_SlotContexts):
    """Self-draft with the target model's bottom layers.

    The draft model is the target's embed + first ``draft_layers`` layers +
    final norm + lm head (layer weights are stacked on a leading L axis, so
    truncation is a slice: no new weights).  It runs greedily over a fixed
    right-padded window of the last ``window`` context tokens."""

    name = "truncated"

    def __init__(self, params, cfg, draft_layers: int | None = None,
                 window: int = 16, device=None, graph_pool=None):
        super().__init__()
        T = draft_layers or max(1, cfg.n_layers // 2)
        self.cfg = dataclasses.replace(cfg, n_layers=T)
        self.window = int(window)
        self.params = dict(params)
        self.params["layers"] = _slice(params["layers"], T)
        dev = torch.device(device or params["embed"]["tokens"].device)
        self._stage = Staging(dev).put
        dcfg = self.cfg

        def next_token(p, toks, valid):
            # causal forward: right pads sit at future positions, so the
            # logits at valid - 1 never see them
            hidden, _ = lm.forward(p, toks, dcfg, mode="prefill",
                                   valid_len=valid)
            row = hidden.index_select(1, valid - 1)
            return torch.argmax(lm.logits_fn(p, row, dcfg)[0, 0], dim=-1)

        W = self.window
        self._next = aot_compile(
            next_token, self.params,
            torch.zeros((1, W), dtype=torch.long, device=dev),
            torch.ones((1,), dtype=torch.long, device=dev), device=dev,
            inputs=(1, 2), pool=graph_pool)

    def propose(self, slot, k):
        ctx = list(self._slot_ctx.get(slot, ())) or [0]
        W = self.window
        out = np.empty(k, np.int32)
        for j in range(k):
            tail = ctx[-W:]
            toks = np.zeros((1, W), np.int64)
            toks[0, :len(tail)] = tail
            tok = int(self._next(self.params,
                                 self._stage("toks", toks, torch.long),
                                 self._stage("valid", [len(tail)],
                                             torch.long)))
            out[j] = tok
            ctx.append(tok)
        return out


def _slice(tree: dict, n: int) -> dict:
    return {k: (_slice(v, n) if isinstance(v, dict) else v[:n])
            for k, v in tree.items()}


def make_drafter(name: str, params, cfg, vocab: int | None = None,
                 seed: int = 0, device=None, graph_pool=None):
    """Resolve the ``drafter`` knob's categorical value.  ``device`` and
    ``graph_pool``: where the truncated drafter's step runs and the memory
    pool its graph shares with the engine's steps."""
    if name == "ngram":
        return NgramDrafter(vocab or cfg.vocab_size, seed=seed)
    if name == "truncated":
        return TruncatedDrafter(params, cfg, device=device,
                                graph_pool=graph_pool)
    raise ValueError(f"unknown drafter {name!r}")
