"""Flash-attention kernels: the prefill and training attention, forward
and backward.

kernel.py  wrappers of the CUDA kernels (csrc/flash_attention.cu,
           csrc/flash_attention_bwd.cu); CPU tensors run the plain versions
ref.py     plain PyTorch versions: masked attention with an f32 softmax, its
           log-sum-exp, and its gradient by autograd
"""
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "attention_ref",
           "attention_lse_ref", "attention_bwd_ref"]
