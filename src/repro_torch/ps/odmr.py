"""On-Demand Model Relocation (ODMR, paper §V), the part the serving
engine uses: row-granular Type I-b relocation into a freshly allocated
state pool, and a timer that waits for the device.

The mesh form (``relocate_now`` / ``transition_step``: a parameter
placement change lowered into one training step) comes with the mesh
slice of the port.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import synchronize


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
