"""Online statistical-progress estimation (paper §IV).

Extends the Hogwild! offline convergence bound  z >= (H/eps) log(d/eps)  to an
online estimator: after switching to setting X_i at iteration j0, the live
pairs {(j, l^j)} scatter around

    j = j0 + (H_i / l) * log(d_i / l)                      (Eq. 3)

``d_i`` must NOT be co-fit with ``H_i`` (paper's concerns (a)/(b)); it is
pinned by Eq. 5:

    d_i = min{ 2*l^{j0},  max(l^{j0+1..j0+a}) }

and ``H_i`` is then a one-parameter least-squares fit. The remaining
iterations to a target loss eps are  r = (H_i/eps) log(d_i/eps)  (Eq. 4), and
the remaining time is  Y = t_bar * r  (hardware x statistical efficiency).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FittedProgress:
    H: float
    d: float
    j0: float
    l_latest: float
    valid: bool

    def remaining_iters(self, eps: float) -> float:
        """Eq. 4, measured from the latest observed loss (not from scratch)."""
        if not self.valid or eps <= 0:
            return float("inf")
        if self.l_latest <= eps:
            return 0.0
        total_to_eps = (self.H / eps) * np.log(self.d / eps)
        done_to_now = ((self.H / self.l_latest)
                       * np.log(max(self.d / self.l_latest, 1.0)))
        return float(max(total_to_eps - done_to_now, 0.0))

    def iters_from_scratch(self, eps: float) -> float:
        if not self.valid or eps <= 0 or self.d <= eps:
            return 0.0 if self.d <= eps else float("inf")
        return float((self.H / eps) * np.log(self.d / eps))


def fit_progress(iters, losses) -> FittedProgress:
    """Fit (H_i, d_i) from the `a` pairs observed under one setting.

    iters: iteration numbers j (ascending); losses: loss after iteration j.
    The first pair plays the role of (j0, l^{j0}).
    """
    iters = np.asarray(iters, float)
    losses = np.asarray(losses, float)
    assert len(iters) == len(losses) and len(iters) >= 2
    j0, l0 = iters[0], max(losses[0], 1e-12)
    js, ls = iters[1:], np.maximum(losses[1:], 1e-12)

    # Eq. 5: supremum from the d <= 2q*l bound (q>=1), floored so that the
    # log terms in the fit stay non-negative (concern (b)).
    d = float(min(2.0 * l0, np.max(ls)))
    d = max(d, 1e-12)

    # one-parameter LSQ: (j - j0) = H * x, x = (1/l) log(d/l), log clamped >=0
    x = (1.0 / ls) * np.maximum(np.log(d / ls), 0.0)
    y = js - j0
    denom = float(np.dot(x, x))
    if denom <= 0:
        # loss did not drop below d at all — no statistical progress signal
        return FittedProgress(H=float("inf"), d=d, j0=j0,
                              l_latest=float(ls[-1]), valid=False)
    H = float(np.dot(x, y) / denom)
    valid = np.isfinite(H) and H > 0
    return FittedProgress(H=H if valid else float("inf"), d=d, j0=j0,
                          l_latest=float(ls[-1]), valid=valid)


def estimate_remaining_time(iters, losses, iter_times, eps: float) -> dict:
    """Y_i = t_bar * r_i (paper §IV): the BO target for one setting window.

    Robustification beyond the paper (§IV-B territory, recorded in
    EXPERIMENTS.md): Eq. 4 assumes the iterates still converge toward 0.
    On a short noisy window near a plateau, the one-parameter H fit can
    return a spuriously *small* r (log(d/eps) -> 0 while noise keeps the
    x-regressors alive). We therefore also extrapolate the window's
    empirical log-loss decay rate and take

        r = max(r_eq4, log(l_latest / eps) / decay_rate)

    — a window with no measurable decay scores Y = inf (the BO then treats
    the setting as non-converging), and genuinely-converging windows are
    unaffected (both estimates agree in scale).
    """
    iters = np.asarray(iters, float)
    losses = np.asarray(losses, float)
    fit = fit_progress(iters, losses)
    t_bar = float(np.mean(iter_times))
    r = fit.remaining_iters(eps)
    l_latest = float(losses[-1])
    if len(losses) >= 4 and l_latest > eps:
        x = iters - iters.mean()
        ll = np.log(np.maximum(losses, 1e-12))
        denom = float(np.dot(x, x))
        rho = -(float(np.dot(x, ll - ll.mean()) / denom)) if denom else 0.0
        if rho <= 1e-12:
            r = float("inf")
        else:
            r_emp = float(np.log(max(l_latest / eps, 1.0)) / rho)
            r = max(r, r_emp)
    return {"fit": fit, "t_bar": t_bar, "remaining_iters": r,
            "Y": t_bar * r if np.isfinite(r) else float("inf")}


@dataclass
class RemainingTimeObjective:
    """Training objective (paper §IV): Y = predicted remaining seconds until
    the rolling loss reaches ``eps``.  The per-iteration context channel is
    the training loss itself."""
    eps: float
    converge_window: int = 8

    def window_score(self, iters, values, times) -> dict:
        return estimate_remaining_time(iters, values, times, self.eps)

    def peek(self, iters, values, times) -> dict:
        return estimate_remaining_time(iters, values, times, self.eps)

    def is_converged(self, repo) -> bool:
        if len(repo.records) < self.converge_window:
            return False
        return repo.rolling_loss(self.converge_window) <= self.eps
