"""Low-overhead nested span tracer (monotonic clock, zero-alloc no-op).

Spans are the unit of time attribution: every instrumented region of the
serving/training stack opens a named span, spans nest on a per-tracer
stack, and each finished span records its wall duration *and* its self
time (duration minus time spent in child spans).  Self time is what makes
attribution exact — fractions of wall-clock per category sum to ~1.0
instead of double-counting a prefill that ran inside an admission inside
a tick.

Span names are a closed registry (``SPAN_NAMES``): an enabled tracer
rejects unregistered names, and ``tests/test_docs.py`` fails CI when a
registered name has no row in ``docs/OBSERVABILITY.md`` — the taxonomy
cannot silently drift from its documentation.

Disabled tracing must cost nothing on the hot path: ``Tracer(enabled=
False)`` (and the shared ``NOP_TRACER``) returns one preallocated no-op
context manager from every ``span()`` call — no object allocation, no
clock read, no branch beyond the method dispatch.
"""
from __future__ import annotations

import time

# span name -> one-line description.  docs/OBSERVABILITY.md carries the
# same table (with the attribution category from repro_torch.obs.report);
# tests/test_docs.py keeps the three in sync.
SPAN_NAMES = {
    "serve.tick": "one engine scheduling quantum (admission + decode)",
    "serve.admit": "admission of one request: pool reservation + prefill",
    "serve.prefill": "full-prompt prefill executable (bucketed, batch 1)",
    "serve.chunk_prefill": "suffix-only prefill against shared prefix "
                           "blocks (multi-token paged decode)",
    "serve.quant": "int8 re-quantization of freshly written KV rows",
    "serve.decode": "batched decode step: all live slots advance one token",
    "decode.draft": "drafter proposes spec_k tokens per live slot "
                    "(host-side n-gram lookup or truncated-layer forward)",
    "decode.verify": "speculative verify: ONE batched S=spec_k+1 paged "
                     "decode checks every draft against the target model",
    "decode.rollback": "rejected-tail rollback: deferred-COW block "
                       "restore (paged) or state snapshot replay (ssm)",
    "reconfig.apply": "execute a ReconfigPlan (setting adoption + warmup)",
    "reconfig.relayout": "Type I-b state-pool re-layout (live blocks/slots "
                         "relocate)",
    "reconfig.migrate_bg": "one interleaved background-migration batch: "
                           "cold blocks copied into the staged pool "
                           "between ticks",
    "reconfig.commit": "atomic adoption of a staged reconfiguration: "
                       "delta copy + block-table swap + warmup barrier",
    "exec.precompile_bg": "a staged target's step captured between ticks "
                          "against the double-buffered pool",
    "exec.build": "executable-cache miss: trace + AOT-compile a step",
    "tuner.deliberate": "tuner window close: objective score, GP fit, EI "
                        "suggestion, cost gate",
    "train.step": "one training iteration (compiled step execution)",
}


class _NopSpan:
    """Shared do-nothing context manager for disabled tracers."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP_SPAN = _NopSpan()


class _Span:
    __slots__ = ("tr", "name", "args", "t_start", "child_s")

    def __init__(self, tr, name, args):
        self.tr = tr
        self.name = name
        self.args = args

    def __enter__(self):
        self.child_s = 0.0
        self.tr._stack.append(self)
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        dur = t1 - self.t_start
        tr = self.tr
        tr._stack.pop()
        if tr._stack:
            tr._stack[-1].child_s += dur
        if len(tr.events) < tr.max_events:
            tr.events.append({
                "name": self.name,
                "ts": self.t_start - tr.t0,       # seconds since tracer start
                "dur": dur,
                "self": max(dur - self.child_s, 0.0),
                "depth": len(tr._stack),
                "args": self.args,
            })
        return False


class Tracer:
    """Nested monotonic-clock span collector.

    Events are appended on span *exit* (children before parents — the
    Chrome trace format and the attribution report are both order-
    agnostic, they key on ``ts``/``depth``).  ``max_events`` bounds memory
    on very long runs; past it, spans still nest correctly but stop being
    recorded.
    """

    def __init__(self, enabled: bool = True, max_events: int = 1_000_000):
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[dict] = []
        self.instants: list[dict] = []
        self._stack: list[_Span] = []
        self.t0 = time.perf_counter()

    def span(self, name: str, **args):
        """Open a named span: ``with tracer.span("serve.decode"): ...``"""
        if not self.enabled:
            return _NOP_SPAN
        assert name in SPAN_NAMES, \
            f"span {name!r} is not in repro_torch.obs.trace.SPAN_NAMES — " \
            f"register it (and its docs/OBSERVABILITY.md row) first"
        return _Span(self, name, args)

    def instant(self, name: str, **args):
        """Point-in-time marker (Chrome 'i' event), e.g. a tuner decision."""
        if not self.enabled:
            return
        self.instants.append({"name": name,
                              "ts": time.perf_counter() - self.t0,
                              "args": args})

    @property
    def now_s(self) -> float:
        return time.perf_counter() - self.t0

    def summary(self) -> dict:
        """Per-name totals: {name: {count, total_s, self_s}}."""
        out: dict[str, dict] = {}
        for e in self.events:
            row = out.setdefault(e["name"],
                                 {"count": 0, "total_s": 0.0, "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += e["dur"]
            row["self_s"] += e["self"]
        return out


NOP_TRACER = Tracer(enabled=False)
