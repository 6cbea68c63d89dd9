"""PyTorch port: package rules — no JAX or ``repro`` import anywhere in
the port or ``chip_smoke.py``, entry points that refuse to fall back to
the CPU, settings of later slices that raise instead of quietly running
something else, and speculative decoding, the tuning slice
(``--selftune``, ``--trace``, ``serve_loop(tuner=...)``,
``warm_start(space)``, ``reconfigure``, ``--tuning-store``), the hybrid
and moe families and training (``launch/train.py``, with and without
``--self-tune``), which no longer raise."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_pytree
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import reconfig
from repro_torch.core.tuner import TunerConfig, TuningManager
from repro_torch.data.synthetic import (image_dataset, input_specs,
                                        regression_dataset, synthetic_batch)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.lm import _layer
from repro_torch.models.moe import moe_block
from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                 SERVING_RELAYOUT_KNOBS, Request,
                                 ServingEngine, ServingObjective,
                                 serving_knob_space)
from repro_torch.serving.engine import serve_loop

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    # the numpy copies of the tuning slice are walked too
    port = ROOT / "src" / "repro_torch"
    for rel in ("core/gp.py", "core/bo.py", "core/metrics.py",
                "core/objective.py", "core/progress.py", "core/reconfig.py",
                "core/tuner.py", "ps/odmr.py", "serving/objective.py",
                "obs/audit.py", "obs/report.py", "obs/export.py",
                # the training slice
                "core/tree.py", "data/synthetic.py", "optim/optimizers.py",
                "ps/compression.py", "ps/stepfn.py", "ps/trainer.py",
                "ps/lm_job.py", "checkpoint/ckpt.py", "launch/train.py",
                "kernels/flash_attention/kernel.py",
                # the tuning store
                "store/__init__.py", "store/signature.py", "store/store.py",
                "store/golden.py"):
        assert port / rel in files, rel
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


@pytest.mark.parametrize("entry", ["init_params", "engine", "launcher",
                                   "train_launcher", "lm_job",
                                   "synthetic_batch", "regression_dataset",
                                   "image_dataset"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, entry):
    params = lm.init_params(CFG, 0, device="cpu")
    assert params["embed"]["tokens"].device.type == "cpu"
    assert LMJob(CFG, device="cpu").device.type == "cpu"
    call = {
        "init_params": lambda: lm.init_params(CFG, 0),
        "engine": lambda: ServingEngine(params, CFG),
        "launcher": lambda: launch_serve.main(
            ["--arch", "starcoder2-3b", "--reduced", "--duration", "0.1"]),
        "train_launcher": lambda: launch_train.main(
            ["--arch", "starcoder2-3b", "--reduced", "--steps", "1"]),
        "lm_job": lambda: LMJob(CFG),
        "synthetic_batch": lambda: synthetic_batch(
            CFG, ShapeConfig("c", 16, 2, "train")),
        "regression_dataset": lambda: regression_dataset(n=8, d=4),
        "image_dataset": lambda: image_dataset(n=8, hw=4),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("selftune", [False, True])
def test_train_launcher_runs_on_cpu_when_asked(selftune, capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch starcoder2-3b --reduced
    --device cpu --steps 5`` (and with ``--self-tune``) ends in OK; with
    ``--trace`` it writes the trace and the attribution panel."""
    args = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--steps", "5", "--batch", "2", "--seq", "16"]
    if selftune:
        args += ["--self-tune", "--tuner-a", "2", "--tuner-b", "1",
                 "--trace", str(tmp_path / "train.trace.json")]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "done: iters=5" in out
    if selftune:
        assert "final setting" in out and "train_step" in out
        names = {e["name"] for e in json.loads(
            (tmp_path / "train.trace.json").read_text())["traceEvents"]}
        assert "train.step" in names


def test_launcher_runs_on_cpu_when_asked(capsys):
    launch_serve.main(["--arch", "starcoder2-3b", "--reduced", "--device",
                       "cpu", "--rate", "40", "--duration", "0.2",
                       "--gen", "4", "--scenario", "shared_prefix"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "served" in out


@pytest.mark.parametrize("case", ["family", "ssm_train", "mesh_plan",
                                  "remesh_restore"])
def test_later_slices_raise_not_implemented(case, tmp_path):
    """What is left unported raises NotImplementedError: the decode kind
    of input_specs (the JAX package's dense per-slot cache, A7).  The
    mesh (since its slice) runs at one device on the CPU, and a mesh
    larger than the world raises a clear error: a moe block over the
    one-device mesh is the single-device block, a Type I-b plan needs its
    ranks, a re-mesh restore onto one device restores every leaf whole."""
    if case == "family":
        with pytest.raises(NotImplementedError, match="not ported yet"):
            input_specs(CFG, ShapeConfig("d", 16, 2, "decode"))
        return
    from repro_torch.checkpoint import save_pytree
    from repro_torch.distributed.sharding import single_device_meshspec
    ms = single_device_meshspec()
    if case == "ssm_train":
        moe = get_config("llama4-scout-17b-a16e").reduced()
        x = torch.randn((4, moe.d_model)).to(torch.bfloat16)
        p = _layer(lm.init_params(moe, 0, device="cpu")["layers"], 0)["moe"]
        got, want = moe_block(x, p, moe, ms=ms), moe_block(x, p, moe)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif case == "mesh_plan":
        plan = reconfig.plan(dict(DEFAULT_LM_SETTING, mesh_split="2x1"),
                             dict(DEFAULT_LM_SETTING, mesh_split="1x2"))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            LMJob(CFG, device="cpu", n_devices=2).state_adapter({}, plan)
    else:
        save_pytree({"w": torch.arange(6.0)}, str(tmp_path), step=3)
        got, meta = restore_pytree({"w": torch.zeros(6)}, str(tmp_path),
                                   ms=ms)
        assert meta["step"] == 3 and torch.equal(got["w"],
                                                 torch.arange(6.0))


@pytest.mark.parametrize("case", ["tuner", "selftune", "space",
                                  "reconfigure", "store", "selftune_store"])
def test_tuning_slice_runs_on_cpu(case, capsys, tmp_path):
    """What raised until the tuning slice was ported now runs on the CPU:
    ``serve_loop(tuner=...)``, ``launch/serve.py --selftune``,
    ``warm_start(space)``, ``reconfigure`` and ``--tuning-store``: a
    ``--tuning-store`` without ``--selftune`` serves at the fixed setting
    and leaves the store alone; two self-tuned runs on one store, the
    second warm-started from the first's observations and golden
    incumbent."""
    params = lm.init_params(CFG, 0, device="cpu")

    def engine(**setting):
        return ServingEngine(params, CFG, dict(DEFAULT_SERVING_SETTING,
                                               **setting), max_seq=32,
                             device="cpu")

    reqs = [Request(rid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new=4) for i in range(6)]
    if case == "tuner":
        eng = engine(max_batch=2)
        tuner = TuningManager(
            serving_knob_space(), dict(eng.setting),
            TunerConfig(eps=1e-6, a=2, b=2, seed=0),
            objective=ServingObjective(eng),
            reconfig_knob_classes={"mesh_knobs": SERVING_RELAYOUT_KNOBS})
        stats = serve_loop(eng, reqs, tuner)
        assert stats["completed"] == 6 and stats["reconfig_count"] >= 1
        assert stats["tuner_init_quanta"] > 0
    elif case == "selftune":
        launch_serve.main(["--arch", "starcoder2-3b", "--reduced",
                           "--device", "cpu", "--selftune", "--duration",
                           "1.0", "--window", "8", "--init-settings", "2"])
        out = capsys.readouterr().out
        assert "[reconfig@" in out and "final setting" in out
        assert out.rstrip().endswith("OK")
    elif case == "space":
        eng = engine(max_batch=2, quant="int8")
        eng.warm_start(serving_knob_space(), max_prompt=20)
        assert ("prefill", 32, 256) in eng._steps          # other chunks
        for dt in ("float32", "bfloat16"):                 # every dtype
            assert ("quant", 32, dt) in eng._steps
        eng.reconfigure(dict(eng.setting, cache_dtype="bf16"))
        rows = torch.zeros((CFG.n_layers, 32, CFG.n_kv_heads, CFG.hd),
                           dtype=torch.bfloat16)
        assert eng._quant_exec(32)(rows).dtype == torch.bfloat16   # C10
        assert stats_ok(serve_loop(eng, reqs))
    elif case == "reconfigure":
        eng = engine(max_batch=1)
        assert eng.reconfigure(dict(eng.setting, max_batch=2)) >= 0.0
        assert eng.pool.n_slots == 2 and eng.setting["max_batch"] == 2
        assert stats_ok(serve_loop(eng, reqs))
    elif case == "store":
        launch_serve.main(["--arch", "starcoder2-3b", "--reduced",
                           "--device", "cpu", "--duration", "0.2",
                           "--gen", "4", "--tuning-store",
                           str(tmp_path / "store")])
        out = capsys.readouterr().out
        assert out.rstrip().endswith("OK") and "tuning-store" not in out
    else:
        store = tmp_path / "store"
        args = ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                "--selftune", "--duration", "1.0", "--window", "8",
                "--init-settings", "2", "--tuning-store", str(store),
                "--json-out", str(tmp_path / "stats.json")]
        launch_serve.main(args)
        first = capsys.readouterr().out
        assert "tuning-store: no golden entry for zamba2-1.2b-reduced" \
            in first and "warm-start absorbed 0 obs" in first
        assert (store / "GOLDEN.json").exists()
        launch_serve.main(args)
        second = capsys.readouterr().out
        assert "tuning-store: golden incumbent" in second
        assert "(exact match" in second
        assert "warm-start absorbed" in second and "tier=exact" in second
        assert second.rstrip().endswith("OK")
        stats = json.loads((tmp_path / "stats.json").read_text())
        ws = stats["warm_start"]
        assert ws["absorbed_obs"] > 0 and ws["tier"] == "exact"
        assert ws["init_settings_skipped"] > 0
        assert stats["completed"] == stats["requests"]


def stats_ok(stats):
    return stats["completed"] == stats["requests"] and stats["tokens"] > 0


def test_selftune_trace_writes_a_trace_and_an_audit(tmp_path, capsys):
    """``--selftune --trace PATH``: ``[reconfig@`` lines, the attribution
    panel, ``OK``, and a Chrome trace and an audit JSONL that load back."""
    path = tmp_path / "serve.trace.json"
    launch_serve.main(["--arch", "starcoder2-3b", "--reduced", "--device",
                       "cpu", "--selftune", "--duration", "1.0", "--window",
                       "8", "--init-settings", "2", "--trace", str(path)])
    out = capsys.readouterr().out
    assert "[reconfig@" in out and "attributed:" in out
    assert out.rstrip().endswith("OK")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serve.tick", "serve.decode", "reconfig.commit"} <= names
    audit = [json.loads(line) for line in
             (tmp_path / "serve.trace.json.audit.jsonl").read_text()
             .splitlines()]
    types = {r["type"] for r in audit}
    assert {"decision", "reconfig"} <= types


@pytest.mark.parametrize("family", ["starcoder2-3b", "falcon-mamba-7b"])
def test_spec_k_no_longer_raises(family):
    """Speculative decoding is ported: an engine with spec_k > 0 serves,
    and its stats carry the speculation block."""
    cfg = get_config(family).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=2, spec_k=2.0),
                        max_seq=32, device="cpu")
    from repro_torch.serving import Request
    stats = serve_loop(eng, [Request(rid=0, prompt=np.arange(1, 6,
                                                            dtype=np.int32),
                                     max_new=6)])
    assert stats["completed"] == 1 and stats["tokens"] == 6
    assert stats["speculation"]["spec_ticks"] > 0
    assert stats["speculation"]["spec_k"] == 2


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
