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
memory.  The elastic re-mesh restore (``ms=`` / ``specs=``) comes with the
mesh slice and raises.
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


def save_pytree(tree, directory: str, step: int, extras: dict | None = None):
    """Write ``tree`` (nested dict of tensors) as checkpoint ``step``;
    returns its directory."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    paths, leaves = flatten(tree)
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
    and device.  Returns (template, meta)."""
    if ms is not None or specs is not None:
        raise NotImplementedError(
            "the elastic re-mesh restore (ms=, specs=) is not ported yet: "
            "it comes with the mesh slice")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    tmpl = flatten(template)[1]
    if len(tmpl) != len(meta["dtypes"]):
        raise ValueError(f"checkpoint has {len(meta['dtypes'])} leaves, "
                         f"template {len(tmpl)}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, (dt, t) in enumerate(zip(meta["dtypes"], tmpl)):
            src = _from_numpy(data[f"a{i}"], dt)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"leaf {meta['paths'][i]}: checkpoint "
                                 f"shape {tuple(src.shape)}, template "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return template, meta


class CheckpointManager:
    """Periodic checkpointing with retention (fault-tolerance substrate)."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, tree, step: int, extras: dict | None = None):
        if self.every <= 0 or step % self.every:
            return None
        path = save_pytree(tree, self.directory, step, extras)
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

    def restore_latest(self, template):
        return restore_pytree(template, self.directory)
