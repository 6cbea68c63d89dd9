"""Bounded LRU cache for step callables.

The port runs eagerly, so an entry is a plain Python callable built for
one shape key (the JAX package keeps AOT-compiled executables under the
same keys).

The tuner explores many settings over a long run; each distinct setting (and,
in serving, each distinct prefill bucket / KV-pool shape) produces a compiled
executable.  Unbounded, the cache grows with the exploration history and
pins device/host memory for executables that will never run again.  Both the
training loop and the serving engine cap it with this policy: recency is the
right signal because the tuner revisits good settings and abandons bad ones.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

from repro_torch.obs.trace import NOP_TRACER


class LRUCache:
    def __init__(self, capacity: int = 8):
        assert capacity >= 1
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_time_s = 0.0       # total seconds inside miss factories
        self.tracer = NOP_TRACER      # emits "exec.build" spans per miss

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return default

    def put(self, key, value):
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def absorb(self, key, value, build_s: float = 0.0):
        """Insert an executable that was built *elsewhere* (the serving
        engine's async precompile thread) and credit its measured build
        time, so ``stats()`` reflects every compile regardless of which
        thread paid for it.  Unlike ``get_or_create`` this never invokes a
        factory and emits no span — the caller records the background time
        through its own channel (Tracer.record).  A key already present
        keeps its cached value (the foreground copy won the race)."""
        if key not in self._d:
            self.put(key, value)
        self.build_time_s += max(float(build_s), 0.0)

    def get_or_create(self, key, factory: Callable):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        # a miss is a trace + AOT compile — the dominant reconfiguration
        # cost; attribute it wherever it fires (inside a reconfig window
        # when warmed, inside a tick when a cold path slips through)
        with self.tracer.span("exec.build", key=str(key)):
            t0 = time.perf_counter()
            value = factory()
            self.build_time_s += time.perf_counter() - t0
        self.put(key, value)
        return value

    def stats(self) -> dict:
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "build_time_s": round(self.build_time_s, 4)}

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d

