"""Blockwise int8 quantization kernels (the engine's int8 KV path).

kernel.py  wrappers of the CUDA kernels (csrc/quant.cu); CPU tensors run
           the plain versions
ref.py     plain PyTorch versions (bit-exact references)
"""
from repro_torch.kernels.quant.kernel import dequantize, quantize
from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref

__all__ = ["quantize", "dequantize", "quantize_ref", "dequantize_ref"]
