"""Weight and state bridge: the JAX package's parameter tree and train
state -> the port's, and the port's train state -> numpy.

``params_from_numpy`` takes the tree of ``repro.models.lm.init_params``
(or a checkpoint of it) with every leaf already a numpy array, and returns
the port's nested dict of tensors with the same keys, for every family
the port runs (the hybrid's unstacked ``shared`` block and the encoder's
``frontend/proj`` included).
Layer weights stay stacked on the leading L axis and matrices keep JAX's
(in, out) orientation: nothing is transposed, so ``x @ w`` is JAX's
``einsum("bsd,dh->bsh")``.

``params_to_mesh`` places such a tree on a mesh, each rank keeping its
shards.

``torch.from_numpy`` rejects ml_dtypes' bfloat16, so bf16 leaves go
through float32 (exact for bf16 values) and are cast back.

A train state is ``{"params", "opt": {"m", "v", "count"} (adam) or
{"mu", "count"} or {"count"}, "step", ["grad_queue"]}``, in both packages
with the same keys; ``count`` and ``step`` are 0-dim int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: the port updates its state in place, and on the CPU a tensor
    # from torch.from_numpy would share the caller's (maybe read-only) buffer
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default: the CUDA device; raises without one unless given)."""
    dev = resolve_device(device)

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else _to_tensor(t, dev))

    return conv(tree)


def params_to_mesh(tree: dict, ms, device=None, specs=None) -> dict:
    """The JAX package's parameters (a nested dict of numpy arrays) placed
    on a mesh: this rank's shard of every leaf, per ``specs`` (default:
    ``param_specs`` of the whole shapes), each its own tensor on
    ``device``."""
    from repro_torch.distributed.sharding import param_specs, shard
    dev = resolve_device(device)
    specs = specs if specs is not None else param_specs(tree, ms)

    def conv(t, s):
        if isinstance(t, dict):
            return {k: conv(v, s[k]) for k, v in t.items()}
        return shard(_to_tensor(t, "cpu"), s, ms).to(dev).clone(
            memory_format=torch.contiguous_format)

    return conv(tree, specs)


def train_state_from_numpy(state: dict, device=None) -> dict:
    """The JAX package's train state (every leaf a numpy array: params,
    ``opt``, ``step``, optional ``grad_queue``) -> the port's, on
    ``device`` (default: the CUDA device; raises without one unless
    given).  Same keys, same dtypes (bf16 stays bf16)."""
    return params_from_numpy(state, device)


def train_state_to_numpy(state: dict) -> dict:
    """The inverse, to the host: a nested dict of numpy arrays with the
    same keys; bf16 leaves come back as float32 arrays (numpy has no
    bfloat16; the values are exact), every other dtype as it is."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(state)
