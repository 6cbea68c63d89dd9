#!/usr/bin/env python3
"""Eager steps against their captured CUDA graphs, on one NVIDIA GPU.

    python3 scripts/ab_graph_steps.py [--family dense|ssm|both] [--reps N]

For full-width starcoder2-3b (dense, paged bf16 pool) and falcon-mamba-7b
(ssm), each with random weights from a seed and a serving engine of 8
slots whose pool is filled with random state, three steps of the engine
are run both ways in one process, in turns (eager, graph, graph, eager):

  * decode: one token for each of 8 slots (context bucket 33 of 64 block
    columns, 289-373 tokens of context, for the dense model);
  * prefill: the 320-token bucket, last_idx 300;
  * verify: the speculative S = k+1 decode step (k = 3 dense, 2 ssm).

The eager decode step is also timed once before the process captures
anything.  For each: the wall time of a step (host clock around a synchronised step,
median), its device time (CUDA events around back-to-back steps), and
what one step launches under ``torch.profiler``: kernels on the card and
the host's launch calls (kernel launches, graph launches, asynchronous
copies).  Prints the card's name and power limit first; every number is
this card's.
"""
from __future__ import annotations

import argparse
import gc
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|MemcpyAsync|"
                         r"LaunchKernelExC)")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(torch, fn, reps: int) -> dict:
    """wall ms (median of ``reps`` synchronised steps), device ms (CUDA
    events over ``reps`` back-to-back steps), kernels and host launch
    calls a step (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if "CUDA" in str(e.device_type)]
    return {"wall": statistics.median(walls),
            "device": a.elapsed_time(b) / reps,
            "kernels": sum(e.count for e in dev),
            "host_calls": sum(e.count for e in events
                              if "CUDA" not in str(e.device_type)
                              and HOST_LAUNCH.match(e.key))}


def family_run(torch, arch: str, k: int, reps: int):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
    cfg = get_config(arch)
    params = lm.init_params(cfg, seed=0, device="cuda")
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                   cache_dtype="bf16", spec_k=float(k))
    eng = ServingEngine(params, cfg, setting, max_seq=1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    pool = eng.pool
    for t in (pool.kv if pool.kind == "paged" else pool.state).values():
        for i in range(t.shape[0]):
            t[i].copy_(torch.randn(t.shape[1:], generator=g, device="cuda"))
    if pool.kind == "paged":
        pool.tables[:] = (torch.arange(8 * pool.mb).reshape(8, pool.mb)
                          + 1).numpy()
    pos = torch.tensor([300, 317, 333, 351, 288, 299, 345, 372],
                       dtype=torch.int32, device="cuda")

    def toks(B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device="cuda")

    cols = eng._ctx_cols(372)
    cols_v = eng._ctx_cols(372 + k)
    # the eager step once more before this process captures anything
    kn = ModelKnobs(attn_impl="paged", attn_ctx=cols)
    fresh = measure(torch, lambda: lm.decode_step(
        params, pool.decode_cache(), toks(8, 1), pos, cfg, kn), reps)
    print(f"{arch} decode eager, before any capture: wall "
          f"{fresh['wall']:.3f} ms, device {fresh['device']:.3f} ms",
          flush=True)
    steps = {
        "decode": (eng._decode_exec(cols),
                   (params, pool.decode_cache(), toks(8, 1), pos)),
        "prefill(320)": (eng._prefill_exec(320),
                         (params, toks(1, 320),
                          torch.tensor([300], device="cuda"))),
        f"verify(S={k + 1})": (eng._decode_exec(cols_v, k + 1),
                               (params, pool.decode_cache(), toks(8, k + 1),
                                pos)),
    }
    for name, (entry, args) in steps.items():
        res = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            fn = entry.eager if mode == "eager" else entry
            res[mode].append(measure(torch, lambda: fn(*args), reps))
        for mode, runs in res.items():
            print(f"{arch} {name} {mode}: wall {_both(runs, 'wall')} ms, "
                  f"device {_both(runs, 'device')} ms; "
                  f"{runs[0]['kernels']} kernels and "
                  f"{runs[0]['host_calls']} host launch calls a step",
                  flush=True)
        ratio = (statistics.mean(r["wall"] for r in res["graph"])
                 / statistics.mean(r["wall"] for r in res["eager"]))
        print(f"{arch} {name}: graph/eager wall {ratio:.3f}", flush=True)


def _both(runs, key):
    return " / ".join(f"{r[key]:.3f}" for r in runs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("dense", "ssm", "both"),
                    default="both")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_graph_steps: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build_all
    print(f"card: {card_line()} | torch {torch.__version__}", flush=True)
    build_all()
    if args.family in ("dense", "both"):
        family_run(torch, "starcoder2-3b", 3, args.reps)
        gc.collect()
        torch.cuda.empty_cache()
    if args.family in ("ssm", "both"):
        family_run(torch, "falcon-mamba-7b", 2, args.reps)


if __name__ == "__main__":
    main()
