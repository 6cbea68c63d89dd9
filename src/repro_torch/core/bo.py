"""Loss-aware Bayesian optimization with Expected Improvement (paper §III).

The GP input is the (d+1)-dim vector <encode(X), log-loss>: adding the model
loss to the input space lets the same setting be valued differently early vs
late in training (the paper's key subtlety vs. conventional offline BO). The
target is log(Y) — log remaining time — so EI in log space prefers
multiplicative improvements and tolerates the heavy-tailed noise of Y.
"""
from __future__ import annotations

import math
import random as _random

import numpy as np

from repro_torch.core.gp import GaussianProcess
from repro_torch.core.knobs import KnobSpace


def _phi(z):
    return math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _Phi(z):
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def expected_improvement(mu, sigma, best):
    """EI for *minimization*: E[max(best - f, 0)].  The closed form can
    round a few ulps below 0 where EI is ~0 (z << 0), so it is clamped at
    0: an expectation of a non-negative quantity."""
    out = np.zeros_like(mu)
    for i, (m, s) in enumerate(zip(mu, sigma)):
        if s <= 1e-12:
            out[i] = max(best - m, 0.0)
            continue
        z = (best - m) / s
        out[i] = max((best - m) * _Phi(z) + s * _phi(z), 0.0)
    return out


class LossAwareBO:
    def __init__(self, space: KnobSpace, seed: int = 0,
                 candidate_pool: int = 64, max_obs: int = 64):
        self.space = space
        self.rng = _random.Random(seed)
        self.candidate_pool = candidate_pool
        self.max_obs = max_obs               # sliding window over observations
        self.X: list[list[float]] = []       # encoded <setting, log-loss>
        self.y: list[float] = []             # log remaining time
        self.records: list[tuple[dict, float, float]] = []
        self.gp: GaussianProcess | None = None
        self._fits = 0
        # cost-aware acquisition arithmetic of the most recent suggest()
        # call (None when the legacy cost-blind path ran) — audit fodder.
        self.last_decision: dict | None = None

    # ------------------------------------------------------------- observe
    def observe(self, setting: dict, loss: float, Y: float):
        """Add one training triple <X_i, l_i, Y_i> (paper Fig. 4b)."""
        if not np.isfinite(Y) or Y <= 0:
            Y = 1e9                           # diverged windows: huge time
        x = self.space.encode(setting) + [self._loss_feat(loss)]
        self.X.append(x)
        self.y.append(math.log(Y))
        self.records.append((dict(setting), loss, Y))
        if len(self.y) > self.max_obs:        # sliding window: recent windows
            self.X = self.X[-self.max_obs:]   # match the current loss regime
            self.y = self.y[-self.max_obs:]
            self.records = self.records[-self.max_obs:]
        self.gp = None                        # refit lazily

    def absorb_history(self, obs, cap: int | None = None) -> int:
        """Seed the GP from prior observations (fleet warm-start).

        ``obs`` is an iterable of records shaped like the tuning store's
        on-disk triples — dicts with ``setting``/``loss``/``Y`` (extra
        keys ignored) or bare ``(setting, loss, Y)`` tuples.  Only the
        newest ``cap`` (default: half the sliding window, so fresh local
        evidence always has room to displace imported history) are
        absorbed, and a record is silently skipped when its setting does
        not encode into *this* space — same-family fallback sources may
        carry knobs or values this run does not tune.  Returns the number
        absorbed; the GP refits lazily on the next suggest()."""
        cap = self.max_obs // 2 if cap is None else cap
        rows = list(obs)[-cap:] if cap else []
        absorbed = 0
        for rec in rows:
            if isinstance(rec, dict):
                setting, loss, Y = rec["setting"], rec["loss"], rec["Y"]
            else:
                setting, loss, Y = rec
            s = self._canonical(setting)
            if s is None:
                continue
            try:
                x = self.space.encode(s) + [self._loss_feat(float(loss))]
            except (KeyError, ValueError, TypeError):
                continue                  # foreign knob value: not ours
            Y = float(Y)
            if not np.isfinite(Y) or Y <= 0:
                continue
            self.X.append(x)
            self.y.append(math.log(Y))
            self.records.append((dict(s), float(loss), Y))
            absorbed += 1
        if absorbed:
            if len(self.y) > self.max_obs:
                self.X = self.X[-self.max_obs:]
                self.y = self.y[-self.max_obs:]
                self.records = self.records[-self.max_obs:]
            self.gp = None
        return absorbed

    def _canonical(self, setting: dict) -> dict | None:
        """Project a (possibly JSON-round-tripped) setting onto the space:
        drop foreign keys, restore tuple-valued nominals, require every
        knob present."""
        out = {}
        for k in self.space.knobs:
            if k.name not in setting:
                return None
            v = setting[k.name]
            if isinstance(v, list):
                v = tuple(v)              # JSON turned a tuple value into a list
            out[k.name] = v
        return out

    def forget_setting(self, setting: dict):
        """Drop every stored observation of ``setting`` (load-drift retune:
        the incumbent's past Y values describe a workload that no longer
        exists, and keeping them makes the GP forever confident the stale
        optimum is good — MLtuner's re-search trigger).  Fresh windows under
        the same setting re-observe it against the new workload."""
        from repro_torch.core.knobs import setting_key
        key = setting_key(setting)
        keep = [i for i, (s, _, _) in enumerate(self.records)
                if setting_key(s) != key]
        if len(keep) == len(self.records):
            return 0
        dropped = len(self.records) - len(keep)
        self.X = [self.X[i] for i in keep]
        self.y = [self.y[i] for i in keep]
        self.records = [self.records[i] for i in keep]
        self.gp = None
        return dropped

    @staticmethod
    def _loss_feat(loss: float) -> float:
        return math.log(max(loss, 1e-9))

    def _ensure_fit(self):
        if self.gp is None and len(self.y) >= 2:
            self._fits += 1
            # hyperparameter grid search is amortized over refits
            opt = (self._fits <= 2) or (self._fits % 5 == 0)
            self.gp = GaussianProcess().fit(np.asarray(self.X),
                                            np.asarray(self.y), optimize=opt)

    # ------------------------------------------------------------- suggest
    def suggest(self, current_loss: float, current_setting: dict | None = None,
                explored=None, cost_fn=None, horizon_s: float | None = None):
        """Returns (setting X', expected_improvement_in_seconds, mu_best).

        EI is converted back from log space to seconds so the caller can
        compare it against R_cost (paper §III-C).

        When ``cost_fn`` (setting -> predicted switch seconds) and
        ``horizon_s`` (remaining drift-free horizon) are given, the argmax
        becomes cost-aware: each candidate's break-even time is
        ``switch_cost * best_s / EI_s`` (EI is a per-horizon saving rate, so
        this is how long the improved setting must run before the switch has
        paid for itself), candidates whose break-even exceeds the horizon
        are pruned outright, and the survivors are ranked by EI amortized
        over the horizon, ``EI_s / (1 + breakeven_s / horizon_s)``.  The
        returned ``ei_seconds`` stays the *raw* EI of the chosen candidate
        so the caller's EI-vs-cost gate keeps its meaning; the per-candidate
        cost arithmetic is stashed in ``self.last_decision`` for the audit.
        """
        self.last_decision = None
        if len(self.y) < 2:
            return self.space.sample(self.rng), float("inf"), float("inf")
        self._ensure_fit()

        cands = self.space.enumerate_all(limit=self.candidate_pool)
        if cands is None:
            cands = [self.space.sample(self.rng)
                     for _ in range(self.candidate_pool)]
            if current_setting is not None:
                cands += self.space.neighbors(current_setting, self.rng, 16)
            cands += [dict(s) for s, _, _ in self.records[-8:]]
        lf = self._loss_feat(current_loss)
        Xc = np.asarray([self.space.encode(c) + [lf] for c in cands])
        mu, sigma = self.gp.predict(Xc)

        # EI baseline: what a *switch* improves on (paper §III-C compares
        # EI against the reconfiguration cost of leaving the incumbent).
        # Using the global best posterior here deadlocks a bad incumbent:
        # the clearly-better observed setting shows EI ~ 0 ("no improvement
        # over best") and the tuner freezes where it stands.
        if current_setting is not None:
            mu_c, _ = self.gp.predict(
                np.asarray([self.space.encode(current_setting) + [lf]]))
            best = float(mu_c[0])
        else:
            Xb = np.asarray([self.space.encode(s) + [lf]
                             for s, _, _ in self.records])
            mu_b, _ = self.gp.predict(Xb)
            best = float(np.min(mu_b))

        ei_log = expected_improvement(mu, sigma, best)
        # convert log-EI to seconds: best_time * (1 - exp(-EI_log)) approx
        best_seconds = math.exp(best)
        ei_sec = best_seconds * (1.0 - np.exp(-ei_log))

        if cost_fn is not None and horizon_s is not None and horizon_s > 0 \
                and math.isfinite(best_seconds):
            costs = np.asarray([max(float(cost_fn(c)), 0.0) for c in cands])
            # break-even: EI is seconds saved per best_seconds of running
            # time, i.e. a saving *rate* of EI/best per second — a switch
            # costing C seconds pays for itself after C * best / EI seconds
            # of running the improved setting.
            with np.errstate(divide="ignore", invalid="ignore"):
                breakeven = np.where(ei_sec > 1e-12,
                                     costs * best_seconds / ei_sec,
                                     np.where(costs > 0, np.inf, 0.0))
            amortizable = breakeven <= horizon_s
            score = ei_sec / (1.0 + breakeven / float(horizon_s))
            n_pruned = int(np.sum(~amortizable))
            if amortizable.any():
                masked = np.where(amortizable, score, -np.inf)
                i = int(np.argmax(masked))
            else:
                # every candidate out-costs the horizon: fall back to the
                # amortized score so the decision stays cost-ordered, and
                # let the caller's EI-vs-cost gate reject the switch.
                i = int(np.argmax(score))
            self.last_decision = {
                "horizon_s": float(horizon_s),
                "n_candidates": len(cands),
                "n_pruned": n_pruned,
                "chosen_cost_s": float(costs[i]),
                "chosen_breakeven_s": float(breakeven[i]),
                "chosen_raw_ei_s": float(ei_sec[i]),
                "chosen_amortized_ei_s": float(score[i]),
                "raw_argmax_ei_s": float(np.max(ei_sec)),
            }
        else:
            i = int(np.argmax(ei_log))
        return cands[i], float(ei_sec[i]), best_seconds

    def predicted_Y(self, setting: dict, loss: float) -> float:
        if len(self.y) < 2:
            return float("inf")
        self._ensure_fit()
        mu, _ = self.gp.predict(
            np.asarray([self.space.encode(setting) + [self._loss_feat(loss)]]))
        return float(math.exp(mu[0]))
