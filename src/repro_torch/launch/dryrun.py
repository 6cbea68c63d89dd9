"""Dry run of every (architecture x shape x mesh) cell: does the port's
step fit a card, and what bounds it (the port of the JAX package's
``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
      --shape decode_32k [--multi-pod] [--set serve_params=tp_only]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      [--out DIR]

Each cell brings up rank 0 of the production world (16x16 = 256 ranks,
or 2x16x16 = 512 with ``--multi-pod``) over a fake process group
(``torch.testing``'s ``FakeStore`` and the ``fake`` backend: nothing is
sent), builds the rank's shards of the state as meta tensors (parameters,
optimizer moments or the decode cache; nothing is allocated), and runs
one step of the port, ``build_train_step`` or ``jit_serve_step``, on
them.  Meta tensors take the card's path: the kernels' operators give
their outputs' shapes and launch nothing.  The counters of
``distributed/trace_analysis.py`` watch the step: the peak of live bytes
(``fits`` against the card's 80 GB), the collectives' bytes by kind and
their seconds at each group's link rate, and the matrix products' FLOPs.
Beside them it records the analytic cost model (``distributed/
costmodel.py``), the roofline on the H100 spec sheet and the model FLOPs.

One JSON a cell goes to ``--out`` (default ``build/dryrun/``, which git
ignores).  A cell that does not fit is a result (``status:
"does_not_fit"``); a cell that raises is a failure, and the run exits
non-zero.  The JAX package's compiler and scan knobs that the port does
not carry are listed in each JSON under ``knobs_not_applied``.  It needs
no card and no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (SHAPES_BY_NAME, ShapeConfig,
                                      TrainConfig, applicable_shapes)
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import input_specs
from repro_torch.distributed.costmodel import MeshDims, cell_costs
from repro_torch.distributed.sharding import shape_of
from repro_torch.distributed.trace_analysis import (CollectiveCounter,
                                                    LiveBytes, memory_stats,
                                                    roofline_terms)
from repro_torch.models import lm
from repro_torch.ps.stepfn import (NOT_CARRIED, StepKnobs, build_train_step,
                                   cache_specs, jit_serve_step,
                                   serve_param_specs, state_specs,
                                   train_state_shapes)

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# the JAX package's StepKnobs defaults of the knobs the port does not carry
JAX_DEFAULTS = {"scan_unroll": 1, "q_chunk": 512, "ssm_chunk": 0,
                "attn_skip_masked": False, "seq_shard": False,
                "donate": True}
INT_KNOBS = ("microbatches", "staleness", "scan_unroll", "q_chunk",
             "k_chunk", "ce_chunk", "ssm_chunk")
BOOL_KNOBS = ("attn_skip_masked", "donate", "seq_shard")


def model_flops_global(cfg, shape: ShapeConfig) -> float:
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def default_knobs(cfg, shape: ShapeConfig,
                  optimized: bool = False) -> tuple[StepKnobs, dict]:
    """The JAX package's paper-faithful (or ``optimized``) knobs of a
    cell: (the port's ``StepKnobs``, {knob: value} of those the port does
    not carry)."""
    jax_only = dict(JAX_DEFAULTS)
    if not optimized:
        if shape.kind == "train":
            return StepKnobs(remat="full", k_chunk=1024), jax_only
        return StepKnobs(remat="none", k_chunk=1024), jax_only
    big = cfg.n_params() > 6e10
    ssm = cfg.family in ("ssm", "hybrid")
    if shape.kind in ("train", "prefill"):
        jax_only.update(seq_shard=True, ssm_chunk=64 if ssm else 0,
                        attn_skip_masked=True)
    if shape.kind == "train":
        return StepKnobs(remat="full", ce_chunk=512,
                         microbatches=8 if big else 4,
                         acc_dtype="bf16" if big else "f32"), jax_only
    if shape.kind == "prefill":
        return StepKnobs(remat="none"), jax_only
    # decode: replicating params across data removes the per-step FSDP
    # gather, but fits only when the model-axis shard is small
    tp_ok = cfg.n_params() * 2 / 16 < 4e9
    return StepKnobs(remat="none",
                     serve_params="tp_only" if tp_ok else "fsdp"), jax_only


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a world of ``n`` over the fake backend (nothing is sent),
    torn down after; nothing for ``n == 1``."""
    if n == 1:
        yield
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry run: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meshspec(multi_pod: bool, mesh):
    """The cell's MeshSpec over the fake world (None at one device)."""
    from repro_torch.launch.mesh import make_meshspec, production_meshspec
    if mesh is None:
        return production_meshspec(multi_pod=multi_pod, live=True)
    dp, tp = mesh
    return None if dp * tp == 1 else make_meshspec(dp, tp)


def _shards(shapes, specs, ms, dtype=None):
    """Meta tensors of the rank's shards of (shape, dtype) leaves (or
    shapes, with ``dtype``)."""
    def leaf(s, spec):
        shape = shape_of(s)
        dt = dtype if dtype is not None else s[1]
        if ms is not None:
            shape = tuple(n // ms.size_of(e) for n, e in zip(shape, spec))
        return torch.empty(shape, dtype=dt, device="meta")
    if specs is None:
        return tree_map(lambda s: leaf(s, None), shapes)
    return tree_map(leaf, shapes, specs)


def _build(cfg, shape: ShapeConfig, ms, knobs: StepKnobs, opt_dtype):
    """(step, state args) of one cell on meta tensors: the train state or
    the serving parameters (and the decode cache), and the batch."""
    batch = {k: torch.empty(v[0], dtype=v[1], device="meta")
             for k, v in input_specs(cfg, shape).items() if k != "cache"}
    if shape.kind == "train":
        tc = TrainConfig()
        sshapes = train_state_shapes(cfg, tc, opt_dtype, knobs)
        state = _shards(sshapes, None if ms is None
                        else state_specs(sshapes, ms), ms)
        step = build_train_step(cfg, tc, knobs, ms=ms)
        return step, (state, batch)
    step, shapes = jit_serve_step(cfg, shape, ms, knobs)
    pshapes = shapes if shape.kind == "prefill" else shapes[0]
    pspecs = None if ms is None else serve_param_specs(cfg, ms, knobs)
    params = _shards(pshapes, pspecs, ms, lm._pdt(cfg))
    if shape.kind == "prefill":
        return step, (params, batch)
    cshapes = shapes[1]
    cspecs = None if ms is None else cache_specs(cshapes, ms)
    cache = {k: _shards(s, None if cspecs is None else cspecs[k], ms,
                        lm.cache_dtype(k)) for k, s in cshapes.items()}
    return step, (params, cache, batch["tokens"], batch["pos"])


def run_cell(arch: str, shape, *, multi_pod: bool = False, mesh=None,
             knobs: StepKnobs | None = None, jax_only: dict | None = None,
             opt_dtype=None, save: bool = True, tag: str = "",
             optimized: bool = False, out_dir=None, cfg=None) -> dict:
    """Trace one cell: ``shape`` a name of ``SHAPES_BY_NAME`` or a
    ``ShapeConfig``; ``mesh`` None (the production mesh, 16x16 or
    2x16x16) or (dp, tp) (a fake world of dp * tp ranks; (1, 1) is the
    single-device step with no process group); ``cfg`` overrides the
    registry's config of ``arch``.  Returns the cell's record (and writes
    it as JSON with ``save``)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    base, base_jax = default_knobs(cfg, shape, optimized)
    knobs = knobs or base
    jax_only = dict(base_jax, **(jax_only or {}))
    if opt_dtype is None:
        # >= 100 B parameters keep bf16 moments, as the JAX package's
        opt_dtype = (torch.bfloat16 if cfg.n_params() > 1e11
                     else torch.float32)
    n_world = ((512 if multi_pod else 256) if mesh is None
               else mesh[0] * mesh[1])
    live, coll = LiveBytes(), CollectiveCounter()
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with fake_world(n_world):
        ms = _meshspec(multi_pod, mesh)
        dims = {"data": 1, "model": 1} if ms is None else dict(ms.shape)
        with live:
            step, args = _build(cfg, shape, ms, knobs, opt_dtype)
            arg_bytes = live.live
            with coll, flops:
                out = step(*args)
            del out, step, args
        md = (MeshDims(1, 1, 1) if ms is None else
              MeshDims(n_dev=ms.n_devices, dsz=ms.data_size,
                       msz=ms.model_size))
    trace_s = time.perf_counter() - t0

    ac = cell_costs(cfg, shape, md, remat=knobs.remat,
                    microbatches=knobs.microbatches,
                    opt_bytes_per_param=(12.0 if opt_dtype == torch.bfloat16
                                         else 16.0),
                    ssm_chunk=jax_only["ssm_chunk"],
                    attn_skip=jax_only["attn_skip_masked"],
                    serve_params=knobs.serve_params)
    mem = memory_stats(live, arg_bytes)
    counted = float(flops.get_total_flops())
    cd = coll.to_dict()
    rl = roofline_terms(counted, ac["hbm_bytes_dev"], float(cd["total"]),
                        ac["model_flops_dev"], coll_seconds=cd["seconds"])
    result = {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": dims, "n_devices": md.n_dev,
        "knobs": dataclasses.asdict(knobs),
        "knobs_not_applied": {k: jax_only[k] for k in NOT_CARRIED},
        "opt_dtype": str(opt_dtype).replace("torch.", ""),
        "status": "ok" if mem["fits"] else "does_not_fit",
        "trace_s": round(trace_s, 2),
        "memory": mem,
        "collectives": cd,
        "flops_counted_dev": counted,
        "analytic": ac,
        "roofline": rl.to_dict(),
        "model_flops_global": model_flops_global(cfg, shape),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }
    if save:
        d = Path(out_dir) if out_dir else OUT_DIR
        d.mkdir(parents=True, exist_ok=True)
        where = ("multipod" if multi_pod else "pod") if mesh is None \
            else f"{mesh[0]}x{mesh[1]}"
        with open(d / f"{arch}__{shape.name}__{where}{tag}.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def all_cells():
    for arch, cfg in ARCHS.items():
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def parse_set(text: str) -> tuple[dict, dict]:
    """``k=v,...`` -> (overrides of the port's StepKnobs, values of the
    knobs it does not carry)."""
    port, jax_only = {}, {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        val = (int(v) if k in INT_KNOBS else bool(int(v)) if k in BOOL_KNOBS
               else v)       # remat / compression / serve_params / acc_dtype
        (jax_only if k in NOT_CARRIED else port)[k] = val
    return port, jax_only


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--out", default=None, help=f"default {OUT_DIR}")
    ap.add_argument("--set", default="",
                    help="StepKnobs overrides, e.g. remat=dots,"
                         "microbatches=4,serve_params=tp_only")
    args = ap.parse_args(argv)
    port, jax_only = parse_set(args.set)
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                base, _ = default_knobs(get_config(arch),
                                        SHAPES_BY_NAME[shape],
                                        args.optimized)
                r = run_cell(arch, shape, multi_pod=mp, tag=args.tag,
                             knobs=dataclasses.replace(base, **port),
                             jax_only=jax_only, optimized=args.optimized,
                             out_dir=args.out)
                rl, mem = r["roofline"], r["memory"]
                print(f"[{r['status']}] {label}: trace={r['trace_s']}s "
                      f"peak={mem['peak_estimate_bytes'] / 1e9:.2f}GB "
                      f"bottleneck={rl['bottleneck']} "
                      f"compute={rl['compute_s']:.4f}s "
                      f"memory={rl['memory_s']:.4f}s "
                      f"collective={rl['collective_s']:.4f}s "
                      f"frac={rl['roofline_fraction']:.3f}", flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {label}: {e}", flush=True)
                traceback.print_exc()
    print(f"dry run: {len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t_all:.1f}s, {failures} failed",
          flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
