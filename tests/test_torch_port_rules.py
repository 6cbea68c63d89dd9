"""PyTorch port: package rules — no JAX or ``repro`` import anywhere in
the port or ``chip_smoke.py``, entry points that refuse to fall back to
the CPU, and settings of later slices that raise instead of quietly
running something else."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
from repro_torch.serving.engine import serve_loop

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in FORBIDDEN]
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


CFG = get_config("starcoder2-3b").reduced()


@pytest.mark.parametrize("entry", ["init_params", "engine", "launcher"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, entry):
    params = lm.init_params(CFG, 0, device="cpu")
    assert params["embed"]["tokens"].device.type == "cpu"
    call = {
        "init_params": lambda: lm.init_params(CFG, 0),
        "engine": lambda: ServingEngine(params, CFG),
        "launcher": lambda: launch_serve.main(
            ["--arch", "starcoder2-3b", "--reduced", "--duration", "0.1"]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_launcher_runs_on_cpu_when_asked(capsys):
    launch_serve.main(["--arch", "starcoder2-3b", "--reduced", "--device",
                       "cpu", "--rate", "40", "--duration", "0.2",
                       "--gen", "4", "--scenario", "shared_prefix"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "served" in out


@pytest.mark.parametrize("case", ["spec_k", "tuner", "selftune", "store",
                                  "family", "space", "reconfigure"])
def test_later_slices_raise_not_implemented(case):
    params = lm.init_params(CFG, 0, device="cpu")

    def engine(**setting):
        return ServingEngine(params, CFG, dict(DEFAULT_SERVING_SETTING,
                                               **setting), device="cpu")

    call = {
        "spec_k": lambda: engine(spec_k=2.0),
        "tuner": lambda: serve_loop(engine(), [], tuner=object()),
        "selftune": lambda: launch_serve.main(
            ["--arch", "starcoder2-3b", "--reduced", "--selftune"]),
        "store": lambda: launch_serve.main(
            ["--arch", "starcoder2-3b", "--reduced", "--tuning-store", "x"]),
        "family": lambda: lm.init_params(
            get_config("falcon-mamba-7b").reduced(), 0, device="cpu"),
        "space": lambda: engine().warm_start(space=object()),
        "reconfigure": lambda: engine().reconfigure({"max_batch": 2}),
    }[case]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        call()


def test_kernel_build_cache_is_gitignored():
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).name.startswith(name + "-")
    for flag in ("arch=compute_90a,code=sm_90a", "-O3", "-shared"):
        assert flag in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
