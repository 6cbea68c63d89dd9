"""PyTorch/CUDA port of the self-tuning serving stack (``src/repro``).

The package mirrors ``repro``'s layout and names, imports ``torch`` and
``numpy`` only, and runs on an NVIDIA Hopper card: every Pallas kernel on
its path is a CUDA C++ kernel under ``kernels/csrc``.  On the CPU (the
tests) each kernel wrapper runs its plain PyTorch version instead.
"""
