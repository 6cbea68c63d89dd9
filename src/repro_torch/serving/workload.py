"""Synthetic inference-traffic generators.

Arrival-driven workload modeling (after the online-scheduling literature in
PAPERS.md): each generator produces a *trace* — a list of Requests with
virtual arrival times measured from the start of the serving loop — so a
fixed-setting baseline and a self-tuned run can replay exactly the same
offered load.  Rates are expressed relative to ``rate_rps`` so benchmarks
can calibrate the overload factor against the measured single-slot service
rate of the machine they run on.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.serving.engine import Request


def _mk_request(rid: int, t: float, rng, vocab: int, prompt_lens, max_news):
    plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
    mnew = int(rng.integers(max_news[0], max_news[1] + 1))
    prompt = rng.integers(0, vocab, (plen,)).astype(np.int32)
    return Request(rid=rid, prompt=prompt, max_new=mnew, arrival_s=float(t))


def _thinned_poisson(rate_fn, peak_rate: float, duration_s: float, rng):
    """Non-homogeneous Poisson arrivals by thinning against ``peak_rate``."""
    out, t = [], 0.0
    if peak_rate <= 0:
        return out
    while True:
        t += float(rng.exponential(1.0 / peak_rate))
        if t >= duration_s:
            return out
        if rng.random() <= rate_fn(t) / peak_rate:
            out.append(t)


def poisson_trace(rate_rps: float, duration_s: float, *, vocab: int,
                  seed: int = 0, prompt_lens=(4, 24), max_news=(8, 24)):
    """Steady memoryless load — the canonical M/G/k arrival process."""
    rng = np.random.default_rng(seed)
    times = _thinned_poisson(lambda t: rate_rps, rate_rps, duration_s, rng)
    return [_mk_request(i, t, rng, vocab, prompt_lens, max_news)
            for i, t in enumerate(times)]


def bursty_trace(rate_rps: float, duration_s: float, *, vocab: int,
                 seed: int = 0, burst_factor: float = 4.0,
                 period_s: float = 4.0, duty: float = 0.3,
                 prompt_lens=(4, 24), max_news=(8, 24)):
    """On/off traffic: quiet base load with periodic bursts at
    ``burst_factor`` x the mean — flash crowds / batch-upload patterns."""
    rng = np.random.default_rng(seed)
    base = rate_rps * (1 - duty * burst_factor) / max(1 - duty, 1e-9)
    base = max(base, 0.05 * rate_rps)
    peak = rate_rps * burst_factor

    def rate(t):
        return peak if (t % period_s) < duty * period_s else base

    times = _thinned_poisson(rate, peak, duration_s, rng)
    return [_mk_request(i, t, rng, vocab, prompt_lens, max_news)
            for i, t in enumerate(times)]


def diurnal_trace(rate_rps: float, duration_s: float, *, vocab: int,
                  seed: int = 0, amplitude: float = 0.8,
                  period_s: float = 10.0, prompt_lens=(4, 24),
                  max_news=(8, 24)):
    """Sinusoidal day/night load compressed into ``period_s`` — the regime
    where the best setting genuinely changes over time."""
    rng = np.random.default_rng(seed)
    peak = rate_rps * (1 + amplitude)

    def rate(t):
        return rate_rps * (1 + amplitude * math.sin(2 * math.pi * t / period_s))

    times = _thinned_poisson(rate, peak, duration_s, rng)
    return [_mk_request(i, t, rng, vocab, prompt_lens, max_news)
            for i, t in enumerate(times)]


def mixed_lengths_trace(rate_rps: float, duration_s: float, *, vocab: int,
                        seed: int = 0, long_frac: float = 0.25,
                        short_lens=(4, 12), long_lens=(32, 56),
                        prompt_lens=None, max_news=(8, 24)):
    """Bimodal prompt lengths (chat turns vs pasted documents) — stresses the
    prefill_chunk knob and prefill/decode interleaving.  ``prompt_lens``
    (the common-generator kwarg) overrides the *short* mode so callers can
    pass one bound to every scenario."""
    if prompt_lens is not None:
        short_lens = prompt_lens
    rng = np.random.default_rng(seed)
    times = _thinned_poisson(lambda t: rate_rps, rate_rps, duration_s, rng)
    out = []
    for i, t in enumerate(times):
        lens = long_lens if rng.random() < long_frac else short_lens
        out.append(_mk_request(i, t, rng, vocab, lens, max_news))
    return out


def shared_prefix_trace(rate_rps: float, duration_s: float, *, vocab: int,
                        seed: int = 0, n_templates: int = 2,
                        prefix_len: int = 32, tail_lens=(2, 8),
                        prompt_lens=None, max_news=(8, 24)):
    """Few-shot / system-prompt traffic: every request is one of
    ``n_templates`` fixed prefixes plus a short unique tail — the regime
    where the paged pool's copy-on-write prefix sharing should collapse
    per-request prefill work to the tail."""
    del prompt_lens                       # prefix_len/tail_lens control size
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
                 for _ in range(n_templates)]
    times = _thinned_poisson(lambda t: rate_rps, rate_rps, duration_s, rng)
    out = []
    for i, t in enumerate(times):
        tpl = templates[int(rng.integers(0, n_templates))]
        tail = rng.integers(0, vocab,
                            (int(rng.integers(tail_lens[0],
                                              tail_lens[1] + 1)),))
        prompt = np.concatenate([tpl, tail.astype(np.int32)])
        mnew = int(rng.integers(max_news[0], max_news[1] + 1))
        out.append(Request(rid=i, prompt=prompt, max_new=mnew,
                           arrival_s=float(t)))
    return out


def long_prompt_trace(rate_rps: float, duration_s: float, *, vocab: int,
                      seed: int = 0, prompt_lens=(40, 68), max_news=(4, 12)):
    """Document-heavy traffic: prompts near the sequence capacity with short
    generations — stresses block-granular admission (a max-seq slab pool
    strands memory; the paged pool reserves only the blocks each request
    needs)."""
    rng = np.random.default_rng(seed)
    times = _thinned_poisson(lambda t: rate_rps, rate_rps, duration_s, rng)
    return [_mk_request(i, t, rng, vocab, prompt_lens, max_news)
            for i, t in enumerate(times)]


SCENARIOS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
    "mixed_lengths": mixed_lengths_trace,
    "shared_prefix": shared_prefix_trace,
    "long_prompt": long_prompt_trace,
}


def make_trace(name: str, rate_rps: float, duration_s: float, *, vocab: int,
               seed: int = 0, **kw):
    return SCENARIOS[name](rate_rps, duration_s, vocab=vocab, seed=seed, **kw)
