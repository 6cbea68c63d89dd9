"""Flash-attention forward kernel: the prefill attention.

kernel.py  wrapper of the CUDA kernel (csrc/flash_attention.cu); CPU
           tensors run the plain version
ref.py     plain PyTorch version: masked attention, f32 softmax
"""
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
