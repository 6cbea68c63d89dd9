"""Trace/audit serialization: Chrome trace-event JSON and JSONL.

``write_chrome_trace`` emits the Trace Event Format (complete "X" events
plus instant "i" markers) that Perfetto (https://ui.perfetto.dev) and
chrome://tracing load directly — open the file there to scrub through a
serving run span by span.  ``write_audit_jsonl`` streams the tuning-audit
records one JSON object per line, the shape downstream analysis and the
fleet-tuning roadmap item expect to ingest.
"""
from __future__ import annotations

import json

from repro_torch.obs.report import CATEGORY


def _json_safe(v):
    """Trace args may carry tuples/numpy scalars; coerce to JSON types."""
    try:
        json.dumps(v)
        return v
    except TypeError:
        if isinstance(v, dict):
            return {str(k): _json_safe(x) for k, x in v.items()}
        if isinstance(v, (list, tuple, set)):
            return [_json_safe(x) for x in v]
        return str(v)


def chrome_trace_events(tracer, pid: int = 0, tid: int = 0,
                        process_name: str = "repro") -> list[dict]:
    events = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": tid,
        "args": {"name": process_name},
    }]
    for e in tracer.events:
        events.append({
            "name": e["name"],
            "cat": CATEGORY.get(e["name"], "misc"),
            "ph": "X",
            "ts": round(e["ts"] * 1e6, 3),       # microseconds
            "dur": round(e["dur"] * 1e6, 3),
            "pid": pid, "tid": tid,
            "args": _json_safe(e["args"]),
        })
    for i in tracer.instants:
        events.append({
            "name": i["name"], "cat": "marker", "ph": "i", "s": "t",
            "ts": round(i["ts"] * 1e6, 3), "pid": pid, "tid": tid,
            "args": _json_safe(i["args"]),
        })
    return events


def write_chrome_trace(path: str, tracer, process_name: str = "repro"):
    """Write a Perfetto-loadable trace; returns the event count."""
    events = chrome_trace_events(tracer, process_name=process_name)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def write_audit_jsonl(path: str, audit):
    """One audit record per line; returns the record count."""
    with open(path, "w") as f:
        for rec in audit.records:
            f.write(json.dumps(_json_safe(rec)) + "\n")
    return len(audit.records)
