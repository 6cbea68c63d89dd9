"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device``, they raise instead of quietly
running the plain CPU versions.
"""
from __future__ import annotations

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
