#!/usr/bin/env python3
"""Where the peak of `chip_smoke.py` phase 9's fixed run goes, on the card.

  python3 scripts/phase9_peak.py [--after-parity] [--after-phases]
                                  [--steps N]

Runs phase 9's fixed-run steps (full-width starcoder2-3b, 30 layers, 4 x
512 tokens, DEFAULT_LM_SETTING) in a fresh process, after phase 9's
parity runs with ``--after-parity`` (as `chip_smoke.py` runs them), and
before those after phases 3-8 of `chip_smoke.py` with ``--after-phases``
(its kernel checks and the dense and ssm serving paths, ~6 min), with
the CUDA caching allocator recording its history.  It prints what phase 9
prints (allocated before the state, with it, and the peak over the
steps), then replays the history to the moment of the peak and prints the
live bytes there grouped by the Python frame of the port (or of
`chip_smoke.py`) that allocated them, and the dry run's prediction of the
same cell (`launch/dryrun.py`, meta tensors on the host) beside it.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def frame_of(frames) -> str:
    """The innermost frame of the port or of chip_smoke.py."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name or "chip_smoke" in name:
            return f"{Path(name).name}:{f.get('line')} {f.get('name')}"
    return "(outside the port)"


def live_at_peak(trace):
    """(peak bytes, {frame: bytes live at the peak}) from the allocator's
    trace of one device."""
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
        elif e["action"] == "free_completed":
            total -= live.pop(e["addr"], 0)
        if total > peak:
            peak, at = total, i
    live, groups = {}, collections.Counter()
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    for e in live.values():
        groups[frame_of(e.get("frames", []))] += e["size"]
    return peak, groups


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--after-parity", action="store_true")
    ap.add_argument("--after-phases", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build_all
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.ps.lm_job import (DEFAULT_LM_SETTING, LMJob,
                                       setting_to_stepknobs)
    if not torch.cuda.is_available():
        sys.exit("phase9_peak: no CUDA device")
    print(cs.card_line(), flush=True)
    build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.after_phases:
        import gc
        card = cs.card_line()
        rows = cs.check_kernels(torch)
        cs.check_train_kernels(torch, rows)
        rows["selective_scan"] = cs.check_scan(torch)
        cs.check_hybrid_kernels(torch, rows)
        cs.check_group_kernels(torch, rows, "moe", cs.MOE_H, cs.MOE_K, cs.HD,
                               seed=21)
        cs.check_group_kernels(torch, rows, "vlm", cs.VLM_H, cs.VLM_H,
                               cs.VLM_HD, seed=23)
        cs.check_encoder_kernels(torch, rows)
        cs.check_ssm_train_kernels(torch, rows)
        cs.check_hybrid_train_flash(torch, rows)
        cs.dense_path(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        cs.ssm_path(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
    if args.after_parity or args.after_phases:
        cs.train_parity(torch)
    cfg = cs._train_cfg()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    job = LMJob(cfg, batch=cs.TRAIN_B, seq=cs.TRAIN_S)
    state = job.init_state(DEFAULT_LM_SETTING, seed=0)
    torch.cuda.synchronize()
    with_state = torch.cuda.memory_allocated()
    step = job.step_builder(DEFAULT_LM_SETTING)
    batches = job.batches(0)
    for _ in range(args.steps):
        state, m = step(state, next(batches))
        float(m["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    where = ("after phases 3-8 and the parity runs" if args.after_phases
             else "after the parity runs" if args.after_parity else "fresh")
    print(f"phase9_peak[{where}]"
          f": {args.steps} steps; allocated before the state {base / 1e9:.3f}"
          f" GB, with it {with_state / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB"
          f" (transient {(peak - with_state) / 1e9:.3f} GB)", flush=True)
    replayed, groups = live_at_peak(snap["device_traces"][0])
    print(f"phase9_peak: the allocator's history replayed: peak "
          f"{replayed / 1e9:.3f} GB live; by the frame that allocated it:",
          flush=True)
    for frame, n in groups.most_common(15):
        print(f"  {n / 1e9:8.3f} GB  {frame}", flush=True)
    r = run_cell("starcoder2-3b", ShapeConfig("phase9", cs.TRAIN_S,
                                              cs.TRAIN_B, "train"),
                 mesh=(1, 1), knobs=setting_to_stepknobs(DEFAULT_LM_SETTING),
                 save=False)
    mem = r["memory"]
    print(f"phase9_peak: the dry run predicts peak "
          f"{mem['peak_estimate_bytes'] / 1e9:.3f} GB, transient "
          f"{mem['temp_bytes'] / 1e9:.3f} GB", flush=True)


if __name__ == "__main__":
    main()
