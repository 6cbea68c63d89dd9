"""Per-run time attribution: every second of wall-clock, named.

Folds a ``Tracer``'s finished spans into exclusive (self-time) seconds per
category and divides by wall-clock, so the fractions — decode, prefill,
admission, relayout, recompile, tuner deliberation, residual reconfig
overhead, other — sum to ~1.0.  "other" is the un-instrumented remainder:
scheduler bookkeeping inside a tick plus idle time between ticks; a large
"other" is itself a finding (the loop is waiting, not serving).

With a ``TuningAudit`` attached the report also carries the reconfig count
and seconds by kind and the cost-model calibration residuals — the panel
``benchmarks/bench_serving.py`` publishes per scenario, which is what lets
a regression test say "long_prompt lost 9.5s to relayouts, not folklore".
"""
from __future__ import annotations

# span name -> attribution category.  Every SPAN_NAMES entry must map
# (tests/test_docs.py enforces both directions against the docs table).
CATEGORY = {
    "serve.tick": "other",             # self time = scheduling bookkeeping
    "serve.admit": "admission",        # self time: pool reservation, COW,
                                       # queue bookkeeping (prefill nests)
    "serve.prefill": "prefill",
    "serve.chunk_prefill": "prefill",
    "serve.quant": "prefill",
    "serve.decode": "decode",
    "decode.draft": "draft",           # host-side proposal cost: must stay
                                       # a sliver of decode or spec_k loses
    "decode.verify": "decode",         # the verify step IS the decode step
    "decode.rollback": "rollback",     # COW-record settlement / ssm replay
    "reconfig.apply": "reconfig_other",  # self time: policy adoption,
                                         # cache readiness barrier
    "reconfig.relayout": "relayout",
    "reconfig.migrate_bg": "migrate_bg",  # staged copies between ticks
    "reconfig.commit": "reconfig_other",  # self time: table swap + barrier
                                          # (the delta copy nests as a
                                          # reconfig.relayout child)
    "exec.build": "recompile",
    "exec.precompile_bg": "recompile_bg",  # staged captures between ticks
    "tuner.deliberate": "tuner",
    "train.step": "train_step",
}

# the order the fractions are reported in (and the set the bench panel
# asserts on); categories with zero observed seconds still appear
FRACTION_KEYS = ("decode", "draft", "rollback", "prefill", "admission",
                 "relayout", "recompile", "tuner", "reconfig_other",
                 "migrate_bg", "recompile_bg", "other")

# the foreground switch *stall*: time the serving loop stood still for a
# reconfiguration (synchronous relayouts + delta copies + cold captures).
# A staged switch's block copies and captures run between ticks on the
# tick's thread, so they stall it too: they are reported apart, and
# counted.
STALL_KEYS = ("relayout", "recompile", "migrate_bg", "recompile_bg")


def time_attribution(tracer, wall_s: float, audit=None,
                     extra_keys: tuple = ()) -> dict:
    """Attribute ``wall_s`` seconds of a run across span categories.

    Self-times (span duration minus child spans) are summed per category,
    so nesting never double-counts; the gap between wall-clock and the
    sum of all self-times lands in "other".  ``extra_keys`` admits
    non-serving categories (the training loop adds "train_step")."""
    keys = tuple(FRACTION_KEYS) + tuple(k for k in extra_keys
                                        if k not in FRACTION_KEYS)
    seconds = {k: 0.0 for k in keys}
    counts: dict[str, int] = {}
    for e in tracer.events:
        cat = CATEGORY.get(e["name"], "other")
        if cat not in seconds:          # unmapped extra category
            seconds[cat] = 0.0
        # "other" collects *only* self time by construction; every span's
        # self time lands exactly once
        seconds[cat] += e["self"]
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    covered = sum(seconds.values())
    wall = max(float(wall_s), covered, 1e-9)   # clock-domain guard
    seconds["other"] += wall - covered
    fractions = {k: v / wall for k, v in seconds.items()}
    stall_s = sum(seconds.get(k, 0.0) for k in STALL_KEYS)
    out = {
        "wall_s": round(wall, 4),
        "seconds": {k: round(v, 4) for k, v in seconds.items()},
        "fractions": {k: round(v, 4) for k, v in fractions.items()},
        "fractions_sum": round(sum(fractions.values()), 4),
        "span_counts": counts,
        # foreground reconfiguration stall: what a request actually waits on
        "stall_s_foreground": round(stall_s, 4),
        "stall_fraction": round(stall_s / wall, 4),
    }
    if audit is not None:
        s = audit.summary()
        out["reconfig_count_by_kind"] = s["reconfig_count_by_kind"]
        out["reconfig_s_by_kind"] = s["reconfig_s_by_kind"]
        out["tuner_decisions"] = {"total": s["decisions"],
                                  "switches": s["switches"],
                                  "stays": s["stays"]}
        out["cost_model_calibration"] = s["cost_model_calibration"]
        if s.get("warm_start"):
            # fleet-store provenance rides along with the panel so a bench
            # arm's "where did the saved init quanta come from" is answerable
            out["warm_start"] = s["warm_start"]
        out["stall_ms_per_reconfig"] = round(
            1000.0 * stall_s / max(s["reconfigs"], 1), 3)
    return out


def format_attribution(attr: dict, indent: str = "  ") -> str:
    """Human-readable one-block rendering for launcher --trace output."""
    lines = [f"{indent}wall {attr['wall_s']:.2f}s, attributed:"]
    for k in attr["fractions"]:
        sec = attr["seconds"][k]
        if sec <= 0:
            continue
        lines.append(f"{indent}  {k:<14} {sec:8.2f}s  "
                     f"({attr['fractions'][k]:6.1%})")
    if "reconfig_count_by_kind" in attr and attr["reconfig_count_by_kind"]:
        kinds = ", ".join(f"{k}: {n}x/{attr['reconfig_s_by_kind'][k]:.2f}s"
                          for k, n in attr["reconfig_count_by_kind"].items())
        lines.append(f"{indent}reconfigs by kind: {kinds}")
    cal = attr.get("cost_model_calibration") or {}
    for k, row in cal.items():
        r = row["ratio_actual_over_predicted"]
        lines.append(f"{indent}cost-model {k}: predicted "
                     f"{row['predicted_s']:.2f}s vs actual "
                     f"{row['actual_s']:.2f}s"
                     + (f" (x{r:.2f})" if r is not None else ""))
    return "\n".join(lines)
