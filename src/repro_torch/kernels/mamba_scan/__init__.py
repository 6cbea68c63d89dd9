"""Selective-scan kernel (the mamba1 recurrence of the ssm family).

kernel.py  wrapper of the CUDA kernel (csrc/mamba_scan.cu); CPU tensors
           run the plain version
ref.py     plain PyTorch version (the JAX package's ``ref.py``, with h0)
"""
from repro_torch.kernels.mamba_scan.kernel import selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
