"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel on
the serving path.

paged_attention — decode / suffix-prefill attention over the paged KV pool
flash_attention — prefill attention (causal, GQA, online softmax)
quant           — blockwise int8 quantize / dequantize

Each package holds ``kernel.py`` (the wrapper: checks, allocation, launch,
launch counter; plain version for CPU tensors) and ``ref.py`` (the plain
PyTorch version).  Sources live in ``csrc/``; ``_build`` compiles them with
nvcc at first use and binds them with ctypes.
"""
from repro_torch.kernels._build import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
