"""Bounded LRU cache for step callables, and ``aot_compile``: a step
captured as one CUDA graph.

An entry is the step of one shape key, under the JAX package's keys.  On
the card ``aot_compile`` captures it as a ``torch.cuda.CUDAGraph``, so a
step is one dispatch, as the JAX package's AOT-compiled executables are;
on the CPU it returns the eager callable (the JAX package falls back to
plain ``jax.jit`` the same way).

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

import torch

from repro_torch.kernels import _build
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

    def drop(self, pred) -> int:
        """Remove every entry whose key satisfies ``pred`` (the engine drops
        the graphs captured on a state pool it replaces).  Returns how many
        went."""
        gone = [k for k in self._d if pred(k)]
        for k in gone:
            del self._d[k]
        return len(gone)

    def stats(self) -> dict:
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "build_time_s": round(self.build_time_s, 4)}

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d


_CAPTURE_STREAMS: dict = {}   # device -> the side stream of every capture


def _capture_stream(device) -> "torch.cuda.Stream":
    """One side stream a device for every warm-up and capture.  cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process: a new stream for each capture would hold one more."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class GraphStep:
    """One step captured as a CUDA graph, called like the eager step.

    ``fn(*args)`` sees three kinds of argument, by position:

    * ``inputs``: copied on every call (``copy_(..., non_blocking=True)``)
      into static buffers that the graph reads;
    * ``state``: captured by address (the state pool, which the step
      writes in place); a call must pass the same tensors;
    * the rest (the parameters): captured by address and only read.

    Capture runs no kernel, but the eager warm-up before it does: it runs
    on the static input buffers and, in place of every ``state`` tensor, on
    a zero tensor of its shape, so a capture made mid-serve never writes
    the live pool.  The graph's outputs live in the memory ``pool`` that
    every step of an engine shares; a later replay of any step may reuse
    that memory, so a caller consumes or copies the outputs of one replay
    before it replays any step again (the serving engine reads its logits
    on the host, or copies them, before its next step).

    The kernel wrappers count their launches in ``_build.LAUNCHES`` when
    their Python runs, which a replay does not: the capture records how
    much each count rose (and takes it back, since capture launched
    nothing), and every replay adds that much again.
    """

    def __init__(self, fn, *args, inputs=(), state=(), pool=None):
        self.eager = fn
        self._inputs = tuple(inputs)
        dev = next(t for a in args for t in _tensors(a)).device
        static = [_tree_map(lambda t: t.clone(), a) if i in self._inputs
                  else a for i, a in enumerate(args)]
        self._static = static
        self._bound = {i: [t.data_ptr() for t in _tensors(a)]
                       for i, a in enumerate(args) if i not in self._inputs}
        warm = [_tree_map(torch.zeros_like, a) if i in state else a
                for i, a in enumerate(static)]
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*warm)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        self.graph = torch.cuda.CUDAGraph()
        before = dict(_build.LAUNCHES)
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                self.out = fn(*static)
        finally:
            self.launches = {k: n - before[k]
                             for k, n in _build.LAUNCHES.items()
                             if n != before[k]}
            _build.LAUNCHES.update(before)

    def __call__(self, *args):
        for i, a in enumerate(args):
            if i in self._inputs:
                for dst, src in zip(_tensors(self._static[i]), _tensors(a)):
                    dst.copy_(src, non_blocking=True)
            elif a is not self._static[i] and self._bound[i] != [
                    t.data_ptr() for t in _tensors(a)]:
                raise ValueError(f"argument {i} is not the tensors the "
                                 f"graph captured")
        self.graph.replay()
        for k, n in self.launches.items():
            _build.LAUNCHES[k] += n
        return self.out


def aot_compile(fn, *example_args, device, inputs=(), state=(), pool=None):
    """The step ``fn`` at the shapes of ``example_args``: a ``GraphStep``
    on a CUDA device (a failed capture raises; there is no eager
    fallback), ``fn`` itself on the CPU.  ``inputs``, ``state`` and
    ``pool`` as ``GraphStep`` takes them."""
    if torch.device(device).type != "cuda":
        return fn
    return GraphStep(fn, *example_args, inputs=inputs, state=state,
                     pool=pool)
