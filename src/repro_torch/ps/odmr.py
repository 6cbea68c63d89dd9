"""On-Demand Model Relocation (ODMR, paper §V).

Paper semantics: on a Type I-b reconfiguration (parameter placement
change), do NOT quiesce + checkpoint + restore.  Relocate each parameter
as part of the normal pull/push cycle, so the new server materializes the
value exactly once.

Multi-controller form: a placement is a spec tree over a mesh, each rank
holding its shards.  ``transition_step`` is one train step that pulls
under the old placement and writes p, m, v and the queue under the new
one: the "original value + update" of the paper is the step's dataflow,
and the relocated result is written once at its new home.
``relocate_now`` moves the state with no step, leaf by leaf (the Type I-b
half of the baseline, and the tests' value-preservation check).  The
baseline (checkpoint + restore) is ``ps.lm_job``'s.

The serving engine uses ``relocate_rows``: row-granular relocation into a
freshly allocated state pool.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.tree import flatten, unflatten
from repro_torch.device import synchronize
from repro_torch.distributed.sharding import (MeshSpec, gather, is_whole,
                                              param_specs, shard)


def reshard_specs(shapes_tree, new_ms: MeshSpec):
    return param_specs(shapes_tree, new_ms)


def transition_step(cfg, tc, old_ms: MeshSpec, new_ms: MeshSpec, knobs=None):
    """One train step that also relocates: the state comes in placed per
    ``old_ms`` (``stepfn.state_specs``), the batch is split over its data
    axes, and p, m, v and the queue leave placed per ``new_ms``."""
    from repro_torch.ps.stepfn import StepKnobs, build_train_step
    return build_train_step(cfg, tc, knobs or StepKnobs(), ms=old_ms,
                            out_ms=new_ms)


@torch.no_grad()
def relocate_now(state: dict, new_specs, new_ms: MeshSpec, old_specs=None,
                 old_ms: MeshSpec | None = None) -> dict:
    """The state placed per ``new_specs`` on ``new_ms``, from its placement
    per ``old_specs`` on ``old_ms`` (None: every leaf whole), values bit
    for bit.  One leaf at a time: its whole tensor is gathered, the new
    shard cut and copied, and the old leaf dropped from ``state`` (the
    state given is spent), so a rank never holds the state twice.  A leaf
    whole in both placements is kept as it is."""
    paths, old = flatten(state)
    ospecs = (flatten(old_specs)[1] if old_specs is not None
              else [None] * len(old))
    nspecs = flatten(new_specs)[1]
    out = []
    for i, (x, so, sn) in enumerate(zip(old, ospecs, nspecs)):
        old[i] = None
        _drop(state, paths[i])
        whole = x if so is None else gather(x, so, old_ms)
        if whole is x and is_whole(sn, new_ms):
            out.append(x)
            continue
        del x
        out.append(shard(whole, sn, new_ms).clone(
            memory_format=torch.contiguous_format))
        del whole
    return unflatten(paths, out)


def _drop(tree: dict, path: str):
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree.pop(last)


def relocate_rows(old_tree: dict, new_tree: dict, src, dst,
                  axis: int = 1) -> dict:
    """Move only the live rows: ``src[i]`` of every leaf of ``old_tree``
    lands at ``dst[i]`` of the matching leaf of ``new_tree``, cast to the
    new leaf's dtype — an ``index_select`` on the old leaf, then an
    ``index_copy_`` into the new one, on the device where the pool lives
    (and on its current stream, so the copies queue behind the steps that
    wrote the old rows).  Rows are slots for the ssm pool and blocks for
    the paged pool, so a re-layout touches O(live data), never the whole
    allocation.  The new leaves are written in place and returned."""
    if len(src) == 0:
        return new_tree
    for k, n in new_tree.items():
        o = old_tree[k]
        s = torch.as_tensor(src, dtype=torch.long, device=o.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=n.device)
        n.index_copy_(axis, d, o.index_select(axis, s).to(n.dtype))
    return new_tree


def timed_blocking(fn, *args, device):
    """``fn(*args)`` and its run time in seconds: the clock is read after
    ``device`` has finished what ``fn`` queued, so the time is the copy's,
    not its launch's."""
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize(torch.device(device))
    return out, time.perf_counter() - t0
