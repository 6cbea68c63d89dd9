"""Observability for the port (copies of the JAX package's ``obs``): the
nested span tracer, the metrics registry, the tuning audit, the per-run
time attribution and the Chrome-trace / audit JSONL export."""
from repro_torch.obs.audit import TuningAudit
from repro_torch.obs.export import write_audit_jsonl, write_chrome_trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_METRICS)
from repro_torch.obs.report import time_attribution
from repro_torch.obs.trace import NOP_TRACER, SPAN_NAMES, Tracer

__all__ = ["Tracer", "NOP_TRACER", "SPAN_NAMES", "TuningAudit",
           "MetricsRegistry", "NULL_METRICS", "Counter", "Gauge",
           "Histogram", "write_chrome_trace", "write_audit_jsonl",
           "time_attribution"]
