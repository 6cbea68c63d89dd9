"""Online reconfiguration planning & cost model (paper §V).

A reconfiguration from setting X to X' is classified into the paper's types:

  Type I-a  training-data relocation    (data-axis / input-pipeline changes)
  Type I-b  model-data relocation       (parameter placement: mesh_split)
  Type II   system-setting only         (recompiled step: remat, chunking,
                                         compression, microbatches, ...)

For each type the executor can use the *baseline* (checkpoint + restore:
CKP + SSR + MDR + TDR) or the efficient scheme (paper's mix-and-match):
TDR for I-a, ODMR for I-b (``ps.odmr``: live rows relocated), plain SSR
(executable swap) for II. ``ReconfigCostModel`` keeps a running per-type
average of *observed* costs, seeded during the initialization phase, which is
what the online phase compares EI against (paper §III-C).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

MESH_KNOBS = ("mesh_split",)                     # Type I-b
DATA_KNOBS = ("data_shards",)                    # Type I-a
# everything else is Type II

# Per-type cost seeds (seconds) used before any observation lands, the JAX
# package's: there a Type II swap is an XLA recompile (cold: seconds), a Type
# I-b ODMR relocation a device_put / collective (tens of ms), and Type I-a
# re-partitions the input pipeline.  On the card a Type II swap captures CUDA
# graphs and a relayout copies rows; the decayed averages learn those.
DEFAULT_KIND_COSTS = {"II": 2.0, "I-b": 0.02, "I-a": 0.5}


def classify(old: dict, new: dict, mesh_knobs: tuple = MESH_KNOBS,
             data_knobs: tuple = DATA_KNOBS) -> tuple[str, ...]:
    """Classify the X -> X' transition.  ``mesh_knobs``/``data_knobs`` let a
    subsystem declare its own knob classes — the serving engine classifies
    KV-pool re-layout knobs (pool size, cache dtype) as Type I-b because
    they relocate model data (the cache), not the executable."""
    kinds = set()
    for k in new:
        if old.get(k) == new[k]:
            continue
        if k in mesh_knobs:
            kinds.add("I-b")
        elif k in data_knobs:
            kinds.add("I-a")
        else:
            kinds.add("II")
    return tuple(sorted(kinds))


@dataclass
class ReconfigCostModel:
    """Exponential-decay running average of observed per-type costs.

    A plain all-time mean never forgets the cold-compile outlier: the first
    Type II swap pays a full compile (a capture on the card), later swaps
    hit the step cache and cost ~nothing, and the mean stays pessimistic
    forever (the tuner then under-explores).  ``decay`` is the weight of
    the newest observation; 0.5 keeps the 2-observation behaviour equal to
    the mean while tracking warm costs within a few swaps.
    """
    avgs: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    default_cost_s: float | None = None   # uniform override for the seeds
    decay: float = 0.5
    # per-unit-of-work averages for kinds whose cost scales with how much
    # state moves (a pool relayout migrating 48 live blocks costs ~10x one
    # migrating 4 — a scalar average learns from cheap light-load moves,
    # then under-prices relayouts during load spikes by >2x exactly when
    # they hurt most).  Keyed like ``avgs``; populated only when callers
    # pass ``scales`` (units of work) to observe/estimate.
    unit_avgs: dict = field(default_factory=dict)
    unit_counts: dict = field(default_factory=dict)

    def apportion(self, kinds: tuple, cost_s: float) -> dict:
        """Split one observed plan cost across its kinds, proportional to
        the current per-kind estimates.  An even split systematically
        mis-calibrates mixed plans — a warm ("I-b", "II") serving switch
        is dominated by the pool relayout while the executable swap hits
        the LRU for ~nothing, yet an even split would charge half to each
        kind forever.  Proportional apportionment is the EM-style fix: the
        better the per-kind averages get, the better the next observation
        is attributed (single-kind plans are unaffected)."""
        kinds = kinds or ("II",)
        ests = {k: max(self.avgs.get(k, self._seed(k)), 1e-9) for k in kinds}
        total = sum(ests.values())
        return {k: cost_s * e / total for k, e in ests.items()}

    def observe(self, kinds: tuple, cost_s: float,
                measured: dict | None = None,
                scales: dict | None = None) -> dict:
        """Fold an observed plan cost into the per-kind averages; returns
        the per-kind apportionment (the audit log records it next to the
        prediction the plan was gated on).

        ``measured`` optionally pins a *measured* per-kind breakdown for a
        subset of the kinds (the serving engine times its pool relayout —
        the I-b portion — directly); those kinds take their measured
        seconds and only the remainder is apportioned over the unmeasured
        kinds.  This is what breaks the mixed-plan fixed point: when every
        plan is ("I-b", "II"), prior-proportional apportionment alone can
        never discover that the priors have the ratio backwards.

        ``scales`` optionally gives the units of work each kind moved
        (blocks migrated by a relayout); those kinds additionally update a
        per-unit average so later estimates can price the *current* amount
        of live state instead of a historical mean."""
        kinds = kinds or ("II",)
        if measured:
            meas = {k: min(max(float(v), 0.0), cost_s)
                    for k, v in measured.items() if k in kinds}
            rest = tuple(k for k in kinds if k not in meas)
            rest_s = max(cost_s - sum(meas.values()), 0.0)
            shares = dict(meas)
            if rest:
                shares.update(self.apportion(rest, rest_s))
        else:
            shares = self.apportion(kinds, cost_s)
        for k, share in shares.items():
            if k in self.avgs:
                self.avgs[k] = (1 - self.decay) * self.avgs[k] \
                    + self.decay * share
            else:
                self.avgs[k] = share
            self.counts[k] = self.counts.get(k, 0) + 1
            u = (scales or {}).get(k)
            if u and u > 0:
                per = share / float(u)
                if k in self.unit_avgs:
                    self.unit_avgs[k] = (1 - self.decay) * self.unit_avgs[k] \
                        + self.decay * per
                else:
                    self.unit_avgs[k] = per
                self.unit_counts[k] = self.unit_counts.get(k, 0) + 1
        return shares

    def _seed(self, kind: str) -> float:
        if self.default_cost_s is not None:
            return self.default_cost_s
        return DEFAULT_KIND_COSTS.get(kind, 1.0)

    def estimate_breakdown(self, kinds: tuple,
                           scales: dict | None = None) -> "CostEstimate":
        """The single derivation both the acquisition and the audit consume:
        per-kind predicted seconds, their sum, and which kinds are still
        priced by the uninformed seed.  A kind with a learned per-unit
        average *and* a caller-supplied current scale is priced
        ``unit_avg * scale`` — the load-aware path; everything else falls
        back to the scalar decayed average (or its seed)."""
        by_kind, seeded = {}, []
        for k in kinds:
            u = (scales or {}).get(k)
            if u and u > 0 and k in self.unit_avgs:
                by_kind[k] = self.unit_avgs[k] * float(u)
            elif k in self.avgs:
                by_kind[k] = self.avgs[k]
            else:
                by_kind[k] = self._seed(k)
                seeded.append(k)
        return CostEstimate(total_s=sum(by_kind.values()),
                            by_kind=by_kind, seeded_kinds=tuple(seeded))

    def estimate_by_kind(self, kinds: tuple,
                         scales: dict | None = None) -> dict:
        return self.estimate_breakdown(kinds, scales=scales).by_kind

    def estimate(self, kinds: tuple, scales: dict | None = None) -> float:
        if not kinds:
            return 0.0
        return self.estimate_breakdown(kinds, scales=scales).total_s


class CostEstimate(NamedTuple):
    """Predicted reconfiguration cost: the scalar the cost gate compares
    against EI, its per-kind breakdown (audit + acquisition read the same
    numbers), and the kinds whose prediction is still the uninformed seed."""
    total_s: float
    by_kind: dict
    seeded_kinds: tuple


@dataclass(frozen=True)
class ReconfigPlan:
    kinds: tuple
    old: dict
    new: dict
    method: str          # "odmr" | "baseline"

    @property
    def needs_relocation(self) -> bool:
        return "I-b" in self.kinds or "I-a" in self.kinds


def plan(old: dict, new: dict, use_odmr: bool = True,
         mesh_knobs: tuple = MESH_KNOBS,
         data_knobs: tuple = DATA_KNOBS) -> ReconfigPlan:
    kinds = classify(old, new, mesh_knobs, data_knobs)
    return ReconfigPlan(kinds=kinds, old=dict(old), new=dict(new),
                        method="odmr" if use_odmr else "baseline")
