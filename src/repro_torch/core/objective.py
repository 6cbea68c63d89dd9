"""Pluggable optimization objectives for the TuningManager.

The paper's tuner minimizes *remaining time to convergence* of a training
job.  The same loss-aware BO machinery also drives serving-time tuning,
where the target is an SLO-penalized time-per-token.  Both are expressed
through this protocol: the TuningManager stays objective-agnostic and only
ever sees a scalar ``Y`` (seconds, smaller is better) per setting window
plus a scalar per-iteration *context value* recorded by the driver (training
loss for the training objective; offered load for serving — the GP input
feature that lets the same setting be valued differently in different
regimes, paper §III-D).

Implementations:
  repro_torch.core.progress.RemainingTimeObjective  — training (paper §IV)
  repro_torch.serving.objective.ServingObjective    — SLO-penalized serving
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Objective(Protocol):
    def window_score(self, iters, values, times) -> dict:
        """Score one closed setting window.

        ``iters``/``values``/``times`` are the (outlier-cleaned) per-iteration
        records of the window; ``values`` is whatever the driver recorded as
        the context channel.  Must return a dict with at least
        ``{"Y": seconds, "t_bar": seconds, "remaining_iters": float}``.
        May consume internal state (called exactly once per window close).
        """
        ...

    def peek(self, iters, values, times) -> dict:
        """Like ``window_score`` but side-effect free (progress reports)."""
        ...

    def is_converged(self, repo) -> bool:
        """Whether the job is done (always False for open-ended serving)."""
        ...
