#!/usr/bin/env python3
"""The mesh over NCCL on four cards: sharded training and Type I-b.

    torchrun --nproc-per-node 4 scripts/mesh_nccl.py [--layers 30]
    # a rehearsal on the CPU (gloo, the reduced config):
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/mesh_nccl.py \\
        --device cpu --reduced

One process a device; starcoder2-3b at full width with random weights
from seed 0, 4 x 512 tokens a step (the reduced config, 8 x 32, with
``--reduced``).

1. For each ``mesh_split`` of the four devices (4x1, 2x2, 1x4): the state
   placed per the split (``LMJob.init_state``), ``--steps`` steps of the
   mesh step (``LMJob.step_builder``): the losses, each step's wall ms
   (every rank waits for its device, then for the others), the peak
   memory of the fullest rank, the kernel launches a rank.
2. At ``--ckpt-layers`` layers, from one trained state on 2x2, Type I-b to
   1x4 three ways: ODMR (an ``odmr`` plan through ``LMJob.state_adapter``:
   ``relocate_now``), the checkpoint baseline (a ``baseline`` plan: the
   sharded save, then ``restore_pytree`` onto the new mesh), and
   ``transition_step`` (one step writing under the new placement) beside a
   2x2 step followed by ``relocate_now``.  Each its seconds (from a barrier
   to a barrier after every rank's device is done), each relocated state
   held to the one it came from, bit for bit (rank 0 keeps the whole state
   on its device and compares leaf by leaf).

Rank 0 prints the card's name and power limit, one JSON line and OK.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SPLITS = ("4x1", "2x2", "1x4")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


class Clock:
    """Seconds between two barriers, every rank's device done first."""

    def __init__(self, device):
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    def __enter__(self):
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.s = time.perf_counter() - self.t0


def whole(job, state, setting):
    """The whole state (every leaf all-gathered), for rank 0 to keep."""
    from repro_torch.distributed.sharding import gather_tree
    return gather_tree(state, job.specs(setting), job.meshspec(setting))


def same_bits(ref, job, state, setting) -> bool:
    """``state`` (placed per ``setting``) gathered leaf by leaf against
    rank 0's whole ``ref``; every rank takes part, rank 0 judges."""
    from repro_torch.core.tree import flatten
    from repro_torch.distributed.sharding import gather
    ms = job.meshspec(setting)
    ok = True
    for x, s, r in zip(flatten(state)[1], flatten(job.specs(setting))[1],
                       flatten(ref)[1] if ref is not None else
                       [None] * len(flatten(state)[1])):
        w = gather(x, s, ms)
        if r is not None:
            ok = ok and r.dtype == w.dtype and bool(torch.equal(r, w))
    return ok


def peak_gb(device) -> float:
    if device.type != "cuda":
        return 0.0
    t = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def splits(args, cfg, device, say):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    out = {}
    for split in SPLITS:
        job = LMJob(cfg, batch=args.batch, seq=args.seq, device=device)
        setting = dict(DEFAULT_LM_SETTING, mesh_split=split)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = job.init_state(setting, seed=0)
        step = job.step_builder(setting)
        batches = job.batches(0)
        reset_launches()
        losses, ms = [], []
        for _ in range(args.steps):
            batch = next(batches)
            with Clock(device) as c:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            ms.append(round(c.s * 1e3, 2))
        out[split] = {"losses": losses, "wall_ms": ms,
                      "peak_gb": round(peak_gb(device), 2),
                      "launches": {k: v for k, v in LAUNCHES.items() if v}}
        say(f"mesh[{split}]: {cfg.n_layers} layers, {args.batch} x "
            f"{args.seq} tokens: losses {losses}, wall ms {ms}, peak "
            f"{out[split]['peak_gb']} GB (fullest rank), launches a rank "
            f"{out[split]['launches']}")
        del state, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def relocations(args, cfg, device, say):
    """Type I-b 2x2 -> 1x4 by ODMR, by the baseline and inside a step."""
    from repro_torch.core import reconfig
    from repro_torch.core.tree import tree_map
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    from repro_torch.ps.odmr import relocate_now, transition_step
    from repro_torch.ps.stepfn import build_train_step
    cfg = dataclasses.replace(cfg, n_layers=args.ckpt_layers)
    rank = dist.get_rank()
    old = dict(DEFAULT_LM_SETTING, mesh_split="2x2")
    new = dict(DEFAULT_LM_SETTING, mesh_split="1x4")
    job = LMJob(cfg, batch=args.batch, seq=args.seq, device=device)
    batches = job.batches(0)
    state = job.init_state(old, seed=1)
    state, _ = job.step_builder(old)(state, next(batches))
    ref = whole(job, state, old)
    ref = ref if rank == 0 else None
    out = {"layers": cfg.n_layers}
    for method in ("odmr", "baseline"):
        copy = tree_map(torch.clone, state)
        plan = reconfig.plan(old, new, method == "odmr")
        with Clock(device) as c:
            moved = job.state_adapter(copy, plan)
        held = same_bits(ref, job, moved, new)
        out[method] = {"s": round(c.s, 3), "bits": held}
        say(f"mesh[I-b {method}]: 2x2 -> 1x4 at {cfg.n_layers} layers in "
            f"{c.s:.3f} s; the state "
            + ("bit for bit" if held or rank else "DIFFERS"))
        del copy, moved
    batch = next(batches)
    ms_old, ms_new = job.meshspec(old), job.meshspec(new)
    tstep = transition_step(cfg, job.tc, ms_old, ms_new)
    plain = build_train_step(cfg, job.tc, ms=ms_old)
    a = tree_map(torch.clone, state)
    with Clock(device) as c:
        a, _ = tstep(a, batch)
    t_trans = c.s
    b = state
    with Clock(device) as c:
        b, _ = plain(b, batch)
    t_step = c.s
    with Clock(device) as c:
        b = relocate_now(b, job.specs(new), ms_new, job.specs(old), ms_old)
    t_move = c.s
    b_whole = whole(job, b, new)
    held = same_bits(b_whole if rank == 0 else None, job, a, new)
    out["transition"] = {"s": round(t_trans, 3), "step_s": round(t_step, 3),
                         "relocate_s": round(t_move, 3), "bits": held}
    say(f"mesh[I-b transition_step]: {t_trans:.3f} s against a 2x2 step "
        f"{t_step:.3f} s + relocate_now {t_move:.3f} s; the states "
        + ("bit for bit" if held or rank else "DIFFER"))
    if rank == 0 and not (out["odmr"]["bits"] and out["baseline"]["bits"]
                          and held):
        raise SystemExit("a relocated state differs")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ckpt-layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_distributed
    rank, size = init_distributed(args.device,
                                  timeout=datetime.timedelta(seconds=240))
    device = torch.device("cuda" if args.device == "cuda" else args.device)
    if size != 4:
        raise SystemExit(f"run it on four ranks (the world has {size})")

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    try:
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            if rank == 0:
                from repro_torch.kernels import build_all
                t0 = time.perf_counter()
                build_all()
                say(f"build: {time.perf_counter() - t0:.1f}s")
            dist.barrier()
            say(card_line())
        cfg = get_config("starcoder2-3b")
        if args.reduced:
            cfg = cfg.reduced()
            args.batch, args.seq = 8, 32
        else:
            args.batch, args.seq = 4, 512
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        say(f"world {size} over {dist.get_backend()}, {cfg.name}, "
            f"{cfg.n_layers} layers")
        t0 = time.perf_counter()
        line = {"splits": splits(args, cfg, device, say)}
        line["type_ib"] = relocations(args, cfg, device, say)
        line["seconds"] = round(time.perf_counter() - t0, 1)
        say(json.dumps(line))
        say("OK")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    main()
