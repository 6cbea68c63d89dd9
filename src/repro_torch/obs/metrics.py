"""Counters, gauges, and histograms for the serving/training stack.

Spans answer *where did the time go*; these answer *how much of X
happened* — executable-cache hits, blocks in use, per-tick latency
distribution.  Instruments are created on demand through a
``MetricsRegistry`` and read back as one plain-dict ``snapshot()`` that
the exporters and bench panels embed.

The disabled form mirrors the tracer's no-op contract: ``NULL_METRICS``
hands out shared instruments whose update methods discard, so
instrumented code never branches on "is observability on".
"""
from __future__ import annotations

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, percentiles
    over the most recent ``cap`` observations (serving runs are long; the
    recent window is the distribution the tuner is acting on)."""
    __slots__ = ("count", "total", "min", "max", "_recent", "_cap", "_i")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._recent: list[float] = []
        self._cap = cap
        self._i = 0

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._recent) < self._cap:
            self._recent.append(v)
        else:                                  # ring buffer past the cap
            self._recent[self._i] = v
            self._i = (self._i + 1) % self._cap

    def percentile(self, q: float) -> float | None:
        if not self._recent:
            return None
        return float(np.percentile(self._recent, q))

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class _NullInstrument:
    __slots__ = ()
    value = 0.0
    count = 0

    def inc(self, n: float = 1.0):
        pass

    def set(self, v: float):
        pass

    def observe(self, v: float):
        pass

    def snapshot(self) -> dict:
        return {"count": 0}


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_INSTRUMENT
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_INSTRUMENT
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL_INSTRUMENT
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.snapshot() for k, h in self._hists.items()},
        }


NULL_METRICS = MetricsRegistry(enabled=False)
