"""Structured tuning-audit log: every BO decision, with receipts.

The paper's online phase reconfigures iff EI > R_cost — a claim about two
*predictions* (the GP's expected improvement and the cost model's per-kind
reconfiguration estimate).  The audit log records each decision with those
predictions attached and then, when the switch actually executes, the
observed cost and the post-switch window objective, so the predictions are
checkable after the fact.  ``calibration()`` reduces the reconfig records
to per-kind residuals (log2 of observed/predicted) — the number that says
whether ``ReconfigCostModel`` can be trusted to gate exploration.

Records are plain dicts (JSONL-exportable via ``repro_torch.obs.export``):

  {"type": "decision", ...}   one per tuner deliberation (switch or stay)
  {"type": "reconfig", ...}   one per executed plan: predicted vs actual
  {"type": "window",   ...}   one per closed window: the setting's observed
                              objective (post-switch windows are the
                              "did the move pay off" evidence)
"""
from __future__ import annotations

import math


class TuningAudit:
    def __init__(self):
        self.records: list[dict] = []
        self._seq = 0

    def _add(self, rec: dict) -> dict:
        rec["seq"] = self._seq
        self._seq += 1
        self.records.append(rec)
        return rec

    # ------------------------------------------------------------ recording
    def decision(self, *, window: int, phase: str, candidate: dict,
                 incumbent: dict, switched: bool, reason: str,
                 ei_s: float | None = None, best_s: float | None = None,
                 predicted_cost_s: float | None = None,
                 predicted_by_kind: dict | None = None,
                 threshold_s: float | None = None,
                 horizon_s: float | None = None,
                 acquisition: dict | None = None) -> dict:
        rec = {
            "type": "decision", "window": window, "phase": phase,
            "candidate": dict(candidate), "incumbent": dict(incumbent),
            "switched": bool(switched), "reason": reason,
            "ei_s": ei_s, "best_s": best_s,
            "predicted_cost_s": predicted_cost_s,
            "predicted_by_kind": dict(predicted_by_kind or {}),
            "threshold_s": threshold_s,
        }
        if horizon_s is not None:
            # cost-aware acquisition receipts: the amortization horizon the
            # decision ran under plus the BO's per-candidate cost arithmetic
            # (break-even seconds, how many candidates were pruned) — the
            # calibration panel verifies the amortization math from these
            rec["horizon_s"] = horizon_s
            rec["acquisition"] = dict(acquisition or {})
        return self._add(rec)

    def reconfig(self, *, kinds: tuple, predicted_by_kind: dict,
                 actual_s: float, actual_by_kind: dict, method: str,
                 setting: dict, seeded_kinds: tuple = ()) -> dict:
        return self._add({
            "type": "reconfig", "kinds": list(kinds),
            "predicted_by_kind": dict(predicted_by_kind),
            "predicted_s": float(sum(predicted_by_kind.values())),
            "actual_s": float(actual_s),
            "actual_by_kind": dict(actual_by_kind),
            "method": method, "setting": dict(setting),
            # kinds whose prediction was the uninformed seed (no prior
            # observation); calibration() grades them separately
            "seeded_kinds": list(seeded_kinds),
        })

    def window(self, *, window: int, setting: dict, Y: float,
               phase: str) -> dict:
        return self._add({"type": "window", "window": window,
                          "setting": dict(setting), "Y": Y, "phase": phase})

    def warm_start(self, *, store_key: str, matched_key: str | None,
                   tier: str | None, absorbed_obs: int,
                   init_settings_skipped: int, read_only: bool) -> dict:
        """Fleet-store provenance: which signature this run asked for,
        which key actually supplied history (and at what fallback tier),
        how many observations seeded the GP, and how much of the LHS init
        phase that evidence displaced.  One record per run, written at
        tuner construction — every later decision implicitly builds on
        it."""
        return self._add({
            "type": "warm_start", "store_key": store_key,
            "matched_key": matched_key, "tier": tier,
            "absorbed_obs": int(absorbed_obs),
            "init_settings_skipped": int(init_settings_skipped),
            "read_only": bool(read_only),
        })

    # ----------------------------------------------------------- reductions
    def of_type(self, t: str) -> list[dict]:
        return [r for r in self.records if r["type"] == t]

    def calibration(self) -> dict:
        """Per-kind predicted-vs-observed reconfiguration cost.

        For each executed plan the cost model predicted a per-kind share
        and observed a per-kind apportionment; the residual is
        ``log2(actual / predicted)`` (0 = perfectly calibrated, +1 = the
        model under-estimated by 2x).  Reported per kind: observation
        count, total predicted/actual seconds, the aggregate ratio, the
        mean |log2 residual|, and — the number the CI gate asserts stays
        within 2x — the *warm* ratio, computed only over plans whose
        prediction for that kind was informed by at least one prior
        observation (a model can't be graded on its uninformed seed; it
        *is* graded on failing to learn from the first observation)."""
        per_kind: dict[str, dict] = {}
        for rec in self.of_type("reconfig"):
            seeded = set(rec.get("seeded_kinds", ()))
            for k, pred in rec["predicted_by_kind"].items():
                act = rec["actual_by_kind"].get(k, 0.0)
                row = per_kind.setdefault(k, {
                    "n": 0, "predicted_s": 0.0, "actual_s": 0.0,
                    "n_warm": 0, "predicted_warm_s": 0.0,
                    "actual_warm_s": 0.0, "residuals_log2": []})
                row["n"] += 1
                row["predicted_s"] += pred
                row["actual_s"] += act
                if k not in seeded:
                    row["n_warm"] += 1
                    row["predicted_warm_s"] += pred
                    row["actual_warm_s"] += act
                    if pred > 0 and act > 0:
                        row["residuals_log2"].append(math.log2(act / pred))
        out = {}
        for k, row in per_kind.items():
            res = row.pop("residuals_log2")
            ratio = (row["actual_s"] / row["predicted_s"]
                     if row["predicted_s"] > 0 else None)
            warm = (row["actual_warm_s"] / row["predicted_warm_s"]
                    if row["predicted_warm_s"] > 0 else None)
            out[k] = {
                **{kk: round(v, 6) if isinstance(v, float) else v
                   for kk, v in row.items()},
                "ratio_actual_over_predicted":
                    round(ratio, 4) if ratio is not None else None,
                "ratio_warm":
                    round(warm, 4) if warm is not None else None,
                "mean_abs_log2_residual":
                    round(sum(abs(r) for r in res) / len(res), 4)
                    if res else None,
            }
        return out

    def summary(self) -> dict:
        decisions = self.of_type("decision")
        reconfigs = self.of_type("reconfig")
        by_kind_count: dict[str, int] = {}
        by_kind_s: dict[str, float] = {}
        for rec in reconfigs:
            for k in rec["kinds"]:
                by_kind_count[k] = by_kind_count.get(k, 0) + 1
                by_kind_s[k] = (by_kind_s.get(k, 0.0)
                                + rec["actual_by_kind"].get(k, 0.0))
        warm = self.of_type("warm_start")
        return {
            "decisions": len(decisions),
            "warm_start": warm[0] if warm else None,
            "switches": sum(d["switched"] for d in decisions),
            "stays": sum(not d["switched"] for d in decisions),
            "reconfigs": len(reconfigs),
            "reconfig_count_by_kind": by_kind_count,
            "reconfig_s_by_kind": {k: round(v, 4)
                                   for k, v in by_kind_s.items()},
            "reconfig_total_s": round(sum(r["actual_s"]
                                          for r in reconfigs), 4),
            "cost_model_calibration": self.calibration(),
        }
