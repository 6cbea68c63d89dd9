"""Observability for the port: nested span tracer and metrics registry
(copies of the JAX package's ``obs.trace`` and ``obs.metrics``)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_METRICS)
from repro_torch.obs.trace import NOP_TRACER, SPAN_NAMES, Tracer

__all__ = ["Tracer", "NOP_TRACER", "SPAN_NAMES", "MetricsRegistry",
           "NULL_METRICS", "Counter", "Gauge", "Histogram"]
