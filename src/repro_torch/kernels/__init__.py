"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel on
the serving path, and the backwards of flash attention and of the selective
scan for training.

paged_attention — decode / suffix-prefill attention over the paged KV pool
flash_attention — prefill attention (causal, GQA, online softmax)
quant           — blockwise int8 quantize / dequantize
mamba_scan      — selective scan (the mamba1 recurrence, and mamba2's over
                  channels (head, p)) from a stored state; in training with
                  interval checkpoints, and its backward

Each package holds ``kernel.py`` (the wrapper: checks, allocation, launch,
launch counter; plain version for CPU tensors) and ``ref.py`` (the plain
PyTorch version).  Sources live in ``csrc/``; ``_build`` compiles them with
nvcc at first use and binds them with ctypes.
"""
from repro_torch.kernels._build import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
