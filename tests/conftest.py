import os
import sys

# benchmarks/ (workloads, protocol helpers) is importable from tests
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# tests/ itself, so the offline _hypothesis_compat shim resolves regardless
# of how pytest was invoked
sys.path.insert(0, os.path.dirname(__file__))

# NOTE: no XLA_FLAGS here — tests see the single real CPU device (the 512-dev
# override belongs to repro.launch.dryrun ONLY).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
                   "kernels); skipped where torch sees no CUDA device")
