"""SLO-penalized serving objective for the TuningManager.

Maps serving performance onto the tuner's native currency — seconds — so
the EI > R_cost reconfiguration test (paper §III-C) stays dimensionally
meaningful: ``Y`` is the predicted time to serve the next ``horizon_tokens``
tokens under the window's setting, inflated when the window's p99 request
latency violates the SLO.  The per-quantum context channel recorded by the
driver is the *offered load* (in-flight + queued requests): the GP learns
<setting, load> -> Y, the serving analogue of the paper's loss-aware
<setting, loss> -> remaining-time surface, so the best setting can differ
between a quiet queue and a flash crowd.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServingObjective:
    engine: object                       # ServingEngine (duck-typed)
    slo_p99_s: float = 3.0
    slo_weight: float = 0.25
    slo_excess_cap: float = 4.0          # bound the penalty: under sustained
    horizon_tokens: float = 2000.0       # overload every setting violates the
                                         # SLO and the term must not drown
                                         # the throughput signal
    # snapshot of engine counters at the last window close
    _tok0: int = field(default=0, repr=False)
    _fin0: int = field(default=0, repr=False)

    def __post_init__(self):
        # engines may carry traffic from earlier runs (warmup, a previous
        # scenario) — score only what this objective witnesses
        self._tok0 = self.engine.total_tokens
        self._fin0 = len(self.engine.finished)

    def _score(self, tokens: int, busy_s: float, lats, n_ticks: int) -> dict:
        t_bar = busy_s / max(n_ticks, 1)
        if tokens <= 0 or busy_s <= 0:
            return {"Y": float("inf"), "t_bar": t_bar,
                    "remaining_iters": float("inf"), "sec_per_token": None,
                    "p99_latency_s": None}
        spt = busy_s / tokens
        penalty = 1.0
        p99 = None
        if lats:
            p99 = float(np.percentile(lats, 99))
            excess = max(0.0, p99 / self.slo_p99_s - 1.0)
            penalty += self.slo_weight * min(excess, self.slo_excess_cap)
        Y = spt * penalty * self.horizon_tokens
        return {"Y": Y, "t_bar": t_bar,
                "remaining_iters": Y / max(t_bar, 1e-9),
                "sec_per_token": spt, "p99_latency_s": p99}

    def _window_inputs(self, times):
        tokens = self.engine.total_tokens - self._tok0
        lats = [r.latency_s for r in self.engine.finished[self._fin0:]]
        return tokens, float(np.sum(times)), lats

    def window_score(self, iters, values, times) -> dict:
        tokens, busy, lats = self._window_inputs(times)
        out = self._score(tokens, busy, lats, len(times))
        # consume: the next window scores only its own traffic
        self._tok0 = self.engine.total_tokens
        self._fin0 = len(self.engine.finished)
        return out

    def peek(self, iters, values, times) -> dict:
        tokens, busy, lats = self._window_inputs(times)
        return self._score(tokens, busy, lats, len(times))

    def is_converged(self, repo) -> bool:
        return False                      # serving never "converges"

    def reconfig_scales(self) -> dict:
        """Units of state a Type I-b relayout would migrate *right now*
        (paged: held KV blocks — live + cached both move; ssm: live slot
        rows).  The tuner passes this to ReconfigCostModel.estimate so a
        relayout proposed during a load spike is priced at the spike's
        migration volume, not a historical light-load average."""
        snap = self.engine.pool.snapshot()
        units = snap.get("blocks_held", snap.get("live_slots", 0))
        return {"I-b": max(int(units), 1)}

    def reconfig_scales_for(self, current: dict, candidate: dict) -> dict:
        """Candidate-aware variant: the units the switch would copy in the
        *foreground*.  A same-block-size paged switch runs through the
        staged migration — only the commit delta (≈ each live slot's hot
        tail block) stalls the loop — while a block-size change re-blocks
        every held block stop-the-world.  Pricing both at the full held
        set would make the cost-aware acquisition see staged (near-free)
        moves as expensive as re-blocking ones."""
        snap = self.engine.pool.snapshot()
        held = snap.get("blocks_held", snap.get("live_slots", 0))
        if (self.engine.pool.kind == "paged"
                and int(candidate.get("block_size", 0))
                == int(current.get("block_size", 0))):
            units = snap.get("live_slots", 1)
        else:
            units = held
        return {"I-b": max(int(units), 1)}
