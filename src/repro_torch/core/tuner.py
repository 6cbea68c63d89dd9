"""Tuning Manager — the paper's online optimization framework (§III, Fig. 3).

Lifecycle (phases exactly as §III-B/C):
  1. initialization: run X0 for ``a`` iterations, then ``b`` random settings
     for ``a`` iterations each (a = 3 x workers by the paper's rule);
  2. online tuning: every ``a`` iterations, fit the loss-aware GP, pick X'
     by EI, and reconfigure iff EI > R_cost.

The manager is system-agnostic: a driver (the serving engine's
``serve_loop``) pushes per-iteration metrics in and executes the
ReconfigPlans the manager emits, reporting observed reconfiguration costs
back. It also exposes ``progress_report`` — the remaining-time progress
indicator (paper §VII claims the first such indicator for ML systems).
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass

import numpy as np

from repro_torch.core import reconfig as rc
from repro_torch.core.bo import LossAwareBO
from repro_torch.core.knobs import KnobSpace, setting_key
from repro_torch.core.metrics import MetricsRepository
from repro_torch.core.objective import Objective
from repro_torch.core.progress import RemainingTimeObjective
from repro_torch.obs.audit import TuningAudit
from repro_torch.obs.trace import NOP_TRACER


@dataclass
class TunerConfig:
    eps: float                     # convergence threshold on the loss
    a: int = 0                     # iters per setting window (0 = 3*workers)
    b: int = 10                    # random settings in the init phase
    n_workers: int = 1
    seed: int = 0
    use_odmr: bool = True
    min_ei_seconds: float = 0.0    # extra hysteresis on top of R_cost
    ei_rel_threshold: float = 0.05 # EI must also exceed this x best-remaining
    converge_window: int = 8       # rolling-mean window for the eps test
    # a window closes after `a` iterations OR this much accumulated
    # execution time, whichever first (None = iterations only).  The
    # paper's a = 3 x workers assumes near-uniform iteration cost; serving
    # quanta vary ~100x with prompt length, and a tick-count window under
    # heavy ticks would stretch the init phase past the whole workload.
    window_time_s: float | None = None
    # load-drift detection (MLtuner-style re-search, arXiv 1803.07445):
    # consecutive same-setting windows feed an EWMA/EWVar of the objective;
    # a window whose Y degrades beyond drift_z sigmas marks the incumbent's
    # past observations stale and the tuner re-explores.  Opt-in (0 = off):
    # it targets objectives that track the workload directly (serving
    # time-per-token); a training run's remaining-time estimate can spike
    # on transient machine contention and must not forget its optimum.
    drift_z: float = 0.0
    drift_rel: float = 0.25        # Y must also exceed the EWMA by 25% —
                                   # converged windows shrink the EWVar so a
                                   # bare z-test would fire on ~1% noise
    drift_alpha: float = 0.3       # EWMA weight of the newest window
    drift_min_windows: int = 3     # observations before the z-test arms
    # cost-aware acquisition (None = legacy cost-blind argmax): the
    # amortization horizon in seconds — how long a freshly adopted setting
    # can be expected to run before drift or the next switch invalidates
    # it.  Each candidate's predicted switch cost is converted to a
    # break-even time (cost * best_s / EI_s); candidates that cannot break
    # even within the horizon are pruned before the argmax and the rest
    # are ranked by EI amortized over the horizon, so a moderate-EI
    # zero-cost (Type II-only, warm-executable) move beats a high-EI
    # relayout that would spend its whole win on migration.
    amortize_horizon_s: float | None = None
    # derive the horizon online from the drift detector's observed
    # time-between-drifts (EWMA of drift intervals on the execution-time
    # clock, clamped to horizon_bounds): frequent drift shrinks the
    # horizon — expensive switches must pay off before the next shift —
    # and long quiet stretches extend it.  The amortize_horizon_s
    # constant stays as the pre-evidence fallback (and, with
    # adapt_horizon=False, a fixed override).
    adapt_horizon: bool = False
    horizon_bounds: tuple = (5.0, 120.0)


class TuningManager:
    """Drives one job — training *or* serving — as decided by ``objective``
    (default: the paper's remaining-time-to-convergence training objective).
    The driver's ``record_iteration(value, time)`` context channel must match
    the objective: training loss vs offered load."""

    def __init__(self, space: KnobSpace, x0: dict, cfg: TunerConfig,
                 objective: Objective | None = None,
                 reconfig_knob_classes: dict | None = None,
                 tracer=None, store=None, signature=None,
                 absorb_history: bool = True):
        self.space = space
        self.cfg = cfg
        self.objective = objective or RemainingTimeObjective(
            cfg.eps, cfg.converge_window)
        self._knob_classes = reconfig_knob_classes or {}
        # observability: deliberation spans + the structured audit log
        # (always on — a few dict records per window; the driver exports
        # them via repro_torch.obs.export.write_audit_jsonl)
        self.tracer = tracer or NOP_TRACER
        self.audit = TuningAudit()
        self.a = cfg.a or max(2, 3 * cfg.n_workers)
        self.rng = _random.Random(cfg.seed)
        self.bo = LossAwareBO(space, seed=cfg.seed)
        self.repo = MetricsRepository()
        self.costs = rc.ReconfigCostModel()
        # project x0 onto the space: a driver may hand over a superset
        # setting (e.g. the serving default carries paging knobs an ssm
        # space doesn't tune), and extra keys would make a value-identical
        # BO suggestion look like a switch — a phantom ~0s reconfiguration
        # that poisons the per-kind cost averages
        names = set(space.names())
        self.x0 = {k: v for k, v in x0.items() if k in names}
        self.current = dict(self.x0)
        # stratified (LHS-style) init: the b settings jointly cover every
        # knob's range, so the GP sees both extremes of each ordinal knob
        # before the online phase starts
        self._init_queue = self.space.stratified_samples(self.rng, cfg.b)
        self._window_count = 0
        self._iter = 0
        self._next_boundary = self.a
        self._a_scale = 1          # adaptive stretch once the tuner is stable
        self._start_loss = float("inf")
        self.phase = "init"
        self.repo.begin_window(self.current, float("inf"))
        self.history: list[dict] = []
        # drift tracker: EWMA/EWVar of Y over consecutive windows of the
        # same (incumbent) setting
        self._drift_key = None
        self._drift_mean = 0.0
        self._drift_var = 0.0
        self._drift_n = 0
        self.drift_events: list[dict] = []
        # execution-time clock + drift-interval EWMA (adaptive horizon)
        self._elapsed_s = 0.0
        self._last_drift_t = 0.0
        self._drift_interval_ewma: float | None = None
        # init-phase spend counters: the fleet-store warm-start exists to
        # shrink these, so the bench reads them per arm
        self.init_quanta = 0
        self.init_time_s = 0.0
        # fleet knowledge store: warm-start the GP from the nearest
        # signature's prior observations and flush every new observation /
        # audited decision back (the store is a later slice of the port)
        self._session = None
        self.signature = None
        self.warm_start_info: dict | None = None
        if store is not None:
            raise NotImplementedError(
                "the tuning store (--tuning-store) is not ported yet: it "
                "comes with a later slice of the port")
        # plan proposed but not yet executed: the tuner stays on the
        # incumbent (windows keep scoring the old setting) until the
        # driver reports the reconfiguration done via record_reconfig —
        # which is what lets the serving engine precompile and migrate in
        # the background over many ticks before committing the switch.
        self._pending: rc.ReconfigPlan | None = None

    # --------------------------------------------------------- fleet store
    def close_store(self):
        """Release the store session (segment handle + shared lock); the
        driver calls this when its run ends so a compactor can proceed."""
        if self._session is not None:
            self._session.close()
            self._session = None

    def _persist_decision(self, rec: dict):
        if self._session is not None:
            self._session.record_decision(rec)

    # ----------------------------------------------------- adaptive horizon
    def effective_horizon(self) -> float | None:
        """Amortization horizon for cost-aware acquisition.  Static mode
        returns the configured constant.  Adaptive mode estimates the
        drift-free runway from the EWMA of observed drift intervals —
        extended by the current quiet stretch when it already outlasts the
        EWMA — clamped to ``horizon_bounds``; until the first drift the
        constant stands in (no evidence beats a measured prior)."""
        base = self.cfg.amortize_horizon_s
        if not self.cfg.adapt_horizon:
            return base
        since = self._elapsed_s - self._last_drift_t
        if self._drift_interval_ewma is None:
            if base is not None:
                return base
            est = since
        else:
            est = max(self._drift_interval_ewma, since)
        lo, hi = self.cfg.horizon_bounds
        return min(max(est, lo), hi)

    # ------------------------------------------------------------ metrics in
    def record_iteration(self, loss: float, time_s: float):
        self._iter += 1
        self._elapsed_s += time_s
        if self.phase == "init":
            self.init_quanta += 1
            self.init_time_s += time_s
        self.repo.add(self._iter, time_s, float(loss))

    def record_reconfig(self, plan: rc.ReconfigPlan, cost_s: float,
                        measured: dict | None = None,
                        scales: dict | None = None):
        """Fold the observed cost into the cost model AND audit it against
        what the model predicted when the plan was gated — predicted vs
        actual per plan is the calibration evidence the bench panel and
        the >2x smoke gate read.  ``measured`` carries any per-kind
        seconds the executor timed directly (the serving engine's pool
        relayout), which anchor the apportionment to ground truth;
        ``scales`` the units of work each kind actually moved (relayout
        blocks), which feed the load-aware per-unit averages.

        Calling this also *commits* the pending plan, if this is it: the
        incumbent flips to ``plan.new`` and a fresh window opens under the
        new setting.  Between ``maybe_advance`` returning the plan and
        this call the tuner deliberately stays on the old setting — the
        serving engine uses that gap to precompile executables and migrate
        the pool in the background across many ticks."""
        est = self.costs.estimate_breakdown(plan.kinds, scales=scales)
        shares = self.costs.observe(plan.kinds, cost_s, measured=measured,
                                    scales=scales)
        self.repo.add_reconfig(plan.kinds, cost_s, plan.method)
        self.audit.reconfig(kinds=plan.kinds, predicted_by_kind=est.by_kind,
                            actual_s=cost_s, actual_by_kind=shares,
                            method=plan.method, setting=plan.new,
                            seeded_kinds=est.seeded_kinds)
        if self._pending is not None \
                and setting_key(plan.new) == setting_key(self._pending.new):
            self._pending = None
            self._switch_to(plan.new)
            self._a_scale = 1
            self._next_boundary = self._iter + self.a

    def abandon_reconfig(self, plan: rc.ReconfigPlan):
        """Driver gave up on a proposed plan (e.g. the target became
        inadmissible mid-migration): stay on the incumbent and resume
        normal windowing as if the deliberation had chosen to stay."""
        if self._pending is not None \
                and setting_key(plan.new) == setting_key(self._pending.new):
            self._pending = None
            self._reopen_window()
            self._next_boundary = self._iter + self.a * self._a_scale

    def _reconfig_scales(self) -> dict:
        """Current units-of-work per kind from the objective (e.g. blocks a
        relayout would migrate right now) for load-aware cost estimates;
        objectives without the hook price on scalar averages."""
        fn = getattr(self.objective, "reconfig_scales", None)
        return fn() if callable(fn) else {}

    def _reconfig_scales_for(self, candidate: dict) -> dict:
        """Candidate-aware units-of-work: objectives that know which
        switches run through the staged (background) migration report the
        *foreground* units only — the commit delta for a stageable move,
        the full held set otherwise.  Falls back to the load-level
        scales."""
        fn = getattr(self.objective, "reconfig_scales_for", None)
        if callable(fn):
            return fn(self.current, candidate)
        return self._reconfig_scales()

    @property
    def converged(self) -> bool:
        return self.objective.is_converged(self.repo)

    # --------------------------------------------------------- window close
    def _close_window(self):
        w = self.repo.windows_list[-1]
        if len(w.iters) < 2:
            return
        its, losses, times = self.repo.clean_window(w)
        est = self.objective.window_score(its, losses, times)
        start_loss = losses[0]
        # drift check BEFORE observing: on drift the incumbent's stale
        # observations are dropped, then the fresh (degraded) Y is recorded
        # as the first evidence of the new regime
        self._check_drift(w.setting, est["Y"])
        self.bo.observe(w.setting, start_loss, est["Y"])
        if self._session is not None:
            # flush the fresh observation to the fleet store (one JSONL
            # append + fsync-free flush; read-only sessions drop it)
            self._session.record_observation(w.setting, float(start_loss),
                                             est["Y"])
        # post-switch windows are the "did the move pay off" audit evidence
        self.audit.window(window=self._window_count, setting=w.setting,
                          Y=est["Y"], phase=self.phase)
        self.history.append({
            "window": self._window_count, "setting": dict(w.setting),
            "start_loss": start_loss, "Y": est["Y"],
            "t_bar": est["t_bar"],
            "remaining_iters": est["remaining_iters"],
            "phase": self.phase,
        })

    def _window_time_up(self) -> bool:
        if self.cfg.window_time_s is None:
            return False
        w = self.repo.windows_list[-1]
        scale = self._a_scale if len(self._init_queue) == 0 else 1
        return (len(w.iters) >= 2
                and sum(w.times) >= self.cfg.window_time_s * scale)

    # --------------------------------------------------------- drift detect
    def _check_drift(self, setting: dict, Y: float):
        """EWMA z-score test on the per-window objective of the incumbent.

        Only consecutive windows of the *same* setting feed the tracker (a
        switch resets it: a different setting is expected to score
        differently).  When the newest window degrades beyond ``drift_z``
        sigmas, the workload has shifted under the incumbent; its stored
        observations are forgotten so EI re-explores instead of trusting the
        stale optimum, and the adaptive window stretch is reset."""
        if self.cfg.drift_z <= 0 or not np.isfinite(Y):
            return
        key = setting_key(setting)
        if key != self._drift_key:
            self._drift_key = key
            self._drift_mean, self._drift_var, self._drift_n = Y, 0.0, 1
            return
        sd = np.sqrt(self._drift_var)
        if (self._drift_n >= self.cfg.drift_min_windows and sd > 0
                and (Y - self._drift_mean) / sd > self.cfg.drift_z
                and Y > self._drift_mean * (1.0 + self.cfg.drift_rel)):
            dropped = self.bo.forget_setting(setting)
            # drift-interval EWMA on the execution-time clock: the
            # adaptive amortization horizon is "how long does a regime
            # last around here" (first interval = time since start)
            interval = self._elapsed_s - self._last_drift_t
            self._last_drift_t = self._elapsed_s
            if self._drift_interval_ewma is None:
                self._drift_interval_ewma = interval
            else:
                self._drift_interval_ewma += self.cfg.drift_alpha * (
                    interval - self._drift_interval_ewma)
            self.drift_events.append({
                "window": self._window_count, "setting": dict(setting),
                "Y": Y, "ewma": self._drift_mean,
                "z": float((Y - self._drift_mean) / sd),
                "dropped_obs": dropped,
                "t_s": self._elapsed_s, "interval_s": interval,
                "interval_ewma_s": self._drift_interval_ewma})
            self._a_scale = 1
            self._drift_mean, self._drift_var, self._drift_n = Y, 0.0, 1
            return
        a = self.cfg.drift_alpha
        delta = Y - self._drift_mean
        self._drift_mean += a * delta
        self._drift_var = (1 - a) * (self._drift_var + a * delta * delta)
        self._drift_n += 1

    # ------------------------------------------------------------- stepping
    def maybe_advance(self):
        """Call after each iteration. Returns a ReconfigPlan when the system
        should switch settings (the driver executes it and reports cost).
        The boundary test stays span-free — it runs every iteration; only
        an actual deliberation (window close + GP fit + EI + cost gate)
        opens the "tuner.deliberate" span."""
        if self._pending is not None:
            # a proposed plan is still being staged/executed by the driver;
            # no new deliberation until it commits (record_reconfig) or is
            # abandoned
            return None
        if self._iter < self._next_boundary and not self._window_time_up():
            return None
        with self.tracer.span("tuner.deliberate", window=self._window_count,
                              phase=self.phase):
            return self._deliberate()

    def _deliberate(self):
        self._close_window()
        self._window_count += 1

        if self._init_queue:
            nxt = self._init_queue.pop(0)
            plan = self._plan(nxt)
            scales = self._reconfig_scales_for(nxt)
            est = self.costs.estimate_breakdown(plan.kinds, scales=scales)
            self._persist_decision(self.audit.decision(
                window=self._window_count, phase="init", candidate=nxt,
                incumbent=self.current, switched=True, reason="init_sample",
                predicted_by_kind=est.by_kind,
                predicted_cost_s=est.total_s))
            self._pending = plan
            return plan
        if self.phase == "init":
            self.phase = "online"

        # ---- online tuning phase (§III-C)
        cur_loss = max(self.repo.latest_loss, self.cfg.eps * 1e-3)
        horizon = self.effective_horizon()
        if horizon is not None:
            # cost-aware acquisition: hand the BO a per-candidate switch
            # cost (same classify + estimate_breakdown derivation the gate
            # and the audit use) so it amortizes EI over the horizon and
            # prunes moves that cannot break even in time
            def cost_fn(cand, _cur=self.current):
                kinds = rc.classify(_cur, cand, **self._knob_classes)
                return self.costs.estimate_breakdown(
                    kinds, scales=self._reconfig_scales_for(cand)).total_s
            x_new, ei_s, best_s = self.bo.suggest(
                cur_loss, self.current, cost_fn=cost_fn, horizon_s=horizon)
        else:
            x_new, ei_s, best_s = self.bo.suggest(cur_loss, self.current)
        acq = getattr(self.bo, "last_decision", None)
        stay = setting_key(x_new) == setting_key(self.current)
        if not stay:
            plan = self._plan(x_new)
            est = self.costs.estimate_breakdown(
                plan.kinds, scales=self._reconfig_scales_for(x_new))
            r_cost = est.total_s
            # hysteresis: noisy Y observations inflate EI; require the
            # improvement to also be a meaningful fraction of the predicted
            # remaining time before paying a reconfiguration
            rel = (self.cfg.ei_rel_threshold * best_s
                   if best_s not in (float("inf"),) else 0.0)
            threshold = r_cost + self.cfg.min_ei_seconds + rel
            stay = ei_s <= threshold
            self._persist_decision(self.audit.decision(
                window=self._window_count, phase="online", candidate=x_new,
                incumbent=self.current, switched=not stay,
                reason="switch" if not stay else "ei_below_cost",
                ei_s=ei_s, best_s=best_s, predicted_cost_s=r_cost,
                predicted_by_kind=est.by_kind,
                threshold_s=threshold, horizon_s=horizon, acquisition=acq))
            if not stay:
                self._pending = plan
                return plan
        else:
            self._persist_decision(self.audit.decision(
                window=self._window_count, phase="online", candidate=x_new,
                incumbent=self.current, switched=False, reason="incumbent",
                ei_s=ei_s, best_s=best_s, horizon_s=horizon, acquisition=acq))
        # staying put: stretch the window (less BO overhead once stable,
        # back to `a` after any switch)
        self._a_scale = min(self._a_scale * 2, 16)
        self._reopen_window()
        self._next_boundary = self._iter + self.a * self._a_scale
        return None

    def _plan(self, new: dict) -> rc.ReconfigPlan:
        return rc.plan(self.current, new, self.cfg.use_odmr,
                       **self._knob_classes)

    def _switch_to(self, setting: dict):
        self.current = dict(setting)
        self.repo.begin_window(self.current, self.repo.latest_loss)

    def _reopen_window(self):
        self.repo.begin_window(self.current, self.repo.latest_loss)

    # ------------------------------------------------------- progress report
    def progress_report(self) -> dict:
        """Remaining-time estimate under the current setting (progress bar)."""
        w = self.repo.windows_list[-1]
        if len(w.iters) >= 2:
            its, losses, times = self.repo.clean_window(w)
            est = self.objective.peek(its, losses, times)
            return {"iteration": self._iter, "loss": self.repo.latest_loss,
                    "remaining_iters": est["remaining_iters"],
                    "remaining_time_s": est["Y"], "phase": self.phase,
                    "setting": dict(self.current)}
        return {"iteration": self._iter, "loss": self.repo.latest_loss,
                "remaining_iters": float("inf"),
                "remaining_time_s": float("inf"), "phase": self.phase,
                "setting": dict(self.current)}
