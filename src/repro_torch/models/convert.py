"""Weight bridge: the JAX package's parameter tree -> the port's.

``params_from_numpy`` takes the tree of ``repro.models.lm.init_params``
(or a checkpoint of it) with every leaf already a numpy array, and returns
the port's nested dict of tensors with the same keys.  Layer weights stay
stacked on the leading L axis and matrices keep JAX's (in, out)
orientation: nothing is transposed, so ``x @ w`` is JAX's
``einsum("bsd,dh->bsh")``.

``torch.from_numpy`` rejects ml_dtypes' bfloat16, so bf16 leaves go
through float32 (exact for bf16 values) and are cast back.
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
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default: the CUDA device; raises without one unless given)."""
    dev = resolve_device(device)

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else _to_tensor(t, dev))

    return conv(tree)
