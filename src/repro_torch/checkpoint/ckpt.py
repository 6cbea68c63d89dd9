"""Fault-tolerant checkpointing (CKP/MDR of paper §V; the JAX package's
``checkpoint/ckpt.py``).

Layout, the JAX package's: <dir>/step_<N>/  arrays.npz  (leaves a0, a1, ...)
                                            meta.json   (step, leaf paths,
                                                         dtypes, extras)
Leaves are flattened in sorted key order, as ``jax.tree_util`` flattens a
dict, and bf16 is stored as its uint16 bits, so each package restores the
other's checkpoints.  Writes are atomic (tmp dir + rename); ``latest_step``
skips partial writes, so a job killed mid-checkpoint restarts from the
previous complete one.

The port streams: ``save_pytree`` copies one leaf at a time to the host
and into the archive, and ``restore_pytree`` reads one leaf at a time and
copies it into the template's tensor **in place**, so a full-width state
(51.7 GB) never needs a second copy on the card or a whole copy in host
memory.

On a mesh (``ms=`` / ``specs=``, the state's placement) each leaf is
gathered whole, one at a time, and the mesh's first rank writes the
archive the JAX package writes; the other ranks wait at a barrier.
``restore_pytree(ms=)`` is the elastic re-mesh restore: every rank of the
mesh reads each leaf and keeps its shard, on any mesh, a smaller one
included (a restart on fewer devices).
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch

from repro_torch.core.tree import flatten
from repro_torch.distributed.sharding import gather, param_pspec, shard

_NP_DTYPES = {torch.float32: "float32", torch.int32: "int32",
              torch.int64: "int64", torch.bfloat16: "bfloat16",
              torch.float16: "float16", torch.int8: "int8"}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NP_DTYPES[t.dtype]


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()   # keeps 0-dim
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _writer(ms) -> bool:
    return ms is None or ms.n_devices == 1 or not any(ms.coord.values())


def _mesh_barrier(ms):
    """Every rank of the mesh waits for every other (the data axes, then
    the model axis: a rank past both has seen every rank arrive)."""
    if ms is None or ms.n_devices == 1:
        return
    import torch.distributed as dist
    for axes, n in ((ms.data_axes, ms.data_size),
                    (ms.model_axis, ms.model_size)):
        if n > 1:
            dist.barrier(group=ms.group(axes))


def save_pytree(tree, directory: str, step: int, extras: dict | None = None,
                ms=None, specs=None):
    """Write ``tree`` (nested dict of tensors) as checkpoint ``step``;
    returns its directory.  ``ms`` / ``specs``: the tree is this rank's
    shards of a state placed per ``specs`` on ``ms``, and every rank of the
    mesh calls it."""
    if ms is not None and ms.n_devices > 1:
        if specs is None:
            raise ValueError("a sharded save needs the state's specs")
        paths, lv = flatten(tree)
        lv = (gather(x, s, ms) for x, s in zip(lv, flatten(specs)[1]))
        final = os.path.join(directory, f"step_{step}")
        if _writer(ms):
            _write(paths, lv, directory, step, extras)
        else:
            for _ in lv:                    # take part in every gather
                pass
        _mesh_barrier(ms)
        return final
    return _write(*flatten(tree), directory, step, extras)


def _write(paths, leaves, directory, step, extras):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    dtypes = []
    # np.savez's own format (an uncompressed zip of .npy members), written
    # a leaf at a time
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, x in enumerate(leaves):
            arr, name = _to_numpy(x)
            dtypes.append(name)
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    meta = {"step": step, "paths": paths, "dtypes": dtypes,
            "extras": extras or {}, "wall_time": time.time()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


@torch.no_grad()
def restore_pytree(template, directory: str, step: int | None = None,
                   ms=None, specs=None):
    """Restore checkpoint ``step`` (default: the latest) into ``template``
    (nested dict of tensors, the structure and dtypes wanted): every leaf
    is copied into the template's tensor in place, converted to its dtype
    and device.  Returns (template, meta).

    ``ms``: the elastic re-mesh restore onto that mesh; the template holds
    this rank's shards, and each leaf's spec is ``specs``' or, by default,
    the parameter rule of its path at its stored (whole) shape, as the JAX
    package places a restored leaf."""
    if ms is not None and ms.live and ms.coord is None:
        raise ValueError("this rank is not in the mesh it restores onto")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    tmpl = flatten(template)[1]
    sl = flatten(specs)[1] if specs is not None else None
    if len(tmpl) != len(meta["dtypes"]):
        raise ValueError(f"checkpoint has {len(meta['dtypes'])} leaves, "
                         f"template {len(tmpl)}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, (dt, t) in enumerate(zip(meta["dtypes"], tmpl)):
            src = _from_numpy(data[f"a{i}"], dt)
            if ms is not None:
                spec = (sl[i] if sl is not None
                        else param_pspec(meta["paths"][i], src.shape, ms))
                src = shard(src, spec, ms)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"leaf {meta['paths'][i]}: checkpoint "
                                 f"shape {tuple(src.shape)}, template "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return template, meta


class CheckpointManager:
    """Periodic checkpointing with retention (fault-tolerance substrate)."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 placement=None):
        """``placement``: for a sharded state, a callable returning the
        state's current (ms, specs) (``LMJob.placement``); every rank of
        the mesh then calls ``maybe_save`` and the first one writes."""
        self.directory = directory
        self.every = every
        self.keep = keep
        self.placement = placement

    def maybe_save(self, tree, step: int, extras: dict | None = None):
        if self.every <= 0 or step % self.every:
            return None
        ms, specs = self.placement() if self.placement else (None, None)
        path = save_pytree(tree, self.directory, step, extras, ms=ms,
                           specs=specs)
        if _writer(ms):
            self._gc()
        return path

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_", 1)[1])
                       for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, template, ms=None, specs=None):
        return restore_pytree(template, self.directory, ms=ms, specs=specs)
