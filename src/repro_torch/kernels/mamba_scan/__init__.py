"""Selective-scan kernel (the mamba1 recurrence of the ssm family).

kernel.py  wrappers of the CUDA kernels (csrc/mamba_scan.cu, and its
           backward csrc/mamba_scan_bwd.cu); CPU tensors run the plain
           versions
ref.py     plain PyTorch versions (the JAX package's ``ref.py``, with h0;
           the interval-checkpointed forward and its gradient)
"""
from repro_torch.kernels.mamba_scan.kernel import (selective_scan,
                                                   selective_scan_bwd)
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_bwd", "selective_scan_ref"]
