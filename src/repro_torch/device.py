"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device``, they raise instead of quietly
running the plain CPU versions.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present);
    anything else is taken as given (``"cpu"`` runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device):
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock around it measures run time rather than launch time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Staging:
    """Per-step host inputs (tokens, positions, table rows) on the device.

    On the card each (name, shape) has a pinned host buffer and a device
    buffer for the owner's life: ``put`` writes the host array into the
    pinned buffer and copies it over asynchronously.  The pinned buffer is
    rewritten only once its last copy has run (an event), so no copy reads
    a half-written buffer, and none waits for the device's queue as a copy
    from pageable memory would.  On the CPU ``put`` returns a new
    tensor."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: dict = {}

    def put(self, name: str, a, dtype=torch.int32):
        a = np.asarray(a)
        if self.device.type != "cuda":
            return torch.as_tensor(a.copy(), dtype=dtype)
        ent = self._bufs.get((name, a.shape))
        if ent is None:
            ent = self._bufs[(name, a.shape)] = (
                torch.empty(a.shape, dtype=dtype, pin_memory=True),
                torch.empty(a.shape, dtype=dtype, device=self.device),
                torch.cuda.Event())
        else:
            ent[2].synchronize()
        host, dev, copied = ent
        host.numpy()[...] = a
        dev.copy_(host, non_blocking=True)
        copied.record()
        return dev
