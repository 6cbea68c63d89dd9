"""Build, load and count the port's CUDA kernels.

Every source ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface for ``sm_90a`` and loaded with ``ctypes``.
Libraries go to ``build/kernels/`` at the repository root, named by a hash
of the sources and flags, so an edited kernel is rebuilt and an unchanged
one is reused.  Nothing is built when a module is imported: the first
launch builds what it needs, and ``build_all`` builds every kernel at once,
one ``nvcc`` process per source, all started together.

``--use_fast_math`` is deliberately absent: the int8 quantizer must be
bit-exact against its plain version.

``LAUNCHES`` counts kernel launches per wrapper (one per launch, nowhere
else), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "flash_attention", "quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"paged_attention": 0, "flash_attention": 0, "quantize": 0,
            "dequantize": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source in parallel.  Returns {name: compiler output}
    (ptxas register and spill report) for the ones it built; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(name: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """The C entry point ``fn`` of library ``name``: ``n_ptrs`` device
    pointers, ``n_ints`` ints, ``n_floats`` floats, then the stream; it
    returns the ``cudaError_t`` of its launch."""
    f = getattr(library(name), fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_cuda(what: str, *tensors):
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
