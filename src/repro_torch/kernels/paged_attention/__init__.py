"""Paged-attention decode kernel over the serving engine's KV pool.

kernel.py  wrapper of the CUDA kernel (csrc/paged_attention.cu); CPU
           tensors run the plain version
ref.py     plain PyTorch version: dense gather + full-softmax attention
"""
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import (gather_kv,
                                                     paged_attention_ref)

__all__ = ["paged_attention", "paged_attention_ref", "gather_kv"]
