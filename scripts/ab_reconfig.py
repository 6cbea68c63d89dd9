#!/usr/bin/env python3
"""Stop-the-world against staged reconfiguration on the card.

    python3 scripts/ab_reconfig.py [--reps 2] [--json-out PATH]
    python3 scripts/ab_reconfig.py --space

On full-width starcoder2-3b (random weights from a seeded generator,
max_seq 1024, prefix sharing on, every step a captured CUDA graph: 6
decode and 6 suffix-prefill steps hold the pool) each switch — grow
max_batch 4 -> 8, shrink 8 -> 4, re-block block_size 16 -> 8, cache_dtype
bf16 -> f32 — is taken twice on a fresh engine with live requests, at the
same tick: once stop-the-world (``apply_plan``) and once staged
(``begin_reconfig``, then ticks until the commit; a re-block cannot stage
and commits through the stop-the-world fallback).  For each it prints the
foreground stall (stop-the-world: the ``apply_plan`` window; staged: the
event's ``stall_s``, the commit plus the block copies and captures that
ran between ticks on the tick's thread), the commit window alone (wall
time, device synchronised, and CUDA events around the same window), its
relayout span, the part spent dropping the steps captured on the old
tensors (graph destruction), the longest tick while the switch was in
flight against the median tick before it, and the longest and median of
the 20 ticks after it.  ``--space`` instead times ``warm_start`` over
the whole paged knob space (max_batch 1-8) at every prompt length the
engine's max_seq admits, and prints the steps it captured by kind, the
step cache's capacity, the capture seconds and the graph memory.  Needs
one CUDA device.  ``--baseline DIR`` runs the same measurement on the port's
sources in DIR (an earlier tree unpacked there) in turns with this
tree's: baseline, this tree, this tree, baseline, one repetition each.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, os.environ.get("PYTHONPATH") or str(ROOT / "src"))

SWITCHES = {            # name: (start setting, change, live requests)
    "grow 4->8": (dict(max_batch=4), dict(max_batch=8), 4),
    "shrink 8->4": (dict(max_batch=8), dict(max_batch=4), 4),
    "reblock 16->8": (dict(max_batch=4), dict(block_size=8), 4),
    "dtype bf16->f32": (dict(max_batch=4), dict(cache_dtype="f32"), 4),
}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def one(torch, cfg, params, start, change, n_live, staged, seed):
    from repro_torch.core.reconfig import plan
    from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                     SERVING_RELAYOUT_KNOBS, ServingEngine)
    from repro_torch.serving.workload import make_trace
    base = dict(DEFAULT_SERVING_SETTING, block_size=16, cache_dtype="bf16",
                prefix_share=True, **start)
    eng = ServingEngine(params, cfg, base, max_seq=1024, device="cuda")
    eng.warm_start(max_prompt=96)
    reqs = make_trace("poisson", 1000.0, 1.0, vocab=cfg.vocab_size,
                      seed=seed, prompt_lens=(48, 96),
                      max_news=(200, 200))[:n_live]
    for r in reqs:
        eng.submit(r)
    ticks = [eng.step()["dt"] for _ in range(12)]
    if eng.n_active != n_live:
        raise SystemExit(f"{eng.n_active} live requests, wanted {n_live}")
    p = plan(eng.setting, {**eng.setting, **change},
             mesh_knobs=SERVING_RELAYOUT_KNOBS)
    drop = eng._drop_pool_steps
    dropped = {"s": 0.0, "n": 0}

    def timed_drop():
        n = len(eng._steps)
        t0 = time.perf_counter()
        drop()
        dropped["s"] += time.perf_counter() - t0
        dropped["n"] += n - len(eng._steps)

    eng._drop_pool_steps = timed_drop
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    out = {"tick_ms_before": statistics.median(ticks) * 1e3}
    if not staged:
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        eng.apply_plan(p)
        wall = time.perf_counter() - t0
        b.record()
        b.synchronize()
        out.update(stall_s=wall, commit_s=wall,
                   stall_event_ms=a.elapsed_time(b),
                   relayout_s=eng.last_reconfig_breakdown.get("I-b", 0.0),
                   staged=False, max_tick_ms=wall * 1e3)
    else:
        commit = eng._commit_staged

        def timed_commit():
            a.record()
            commit()
            b.record()

        eng._commit_staged = timed_commit
        eng.begin_reconfig(p)
        during = []
        while eng._staged is not None:
            during.append(eng.step()["dt"])
            if len(during) > 500:
                raise SystemExit("the staged switch never committed")
        b.synchronize()
        (ev,) = eng.take_reconfig_events()
        if ev["bg_capture_failures"]:
            raise SystemExit(f"staged captures failed: {ev}")
        out.update(stall_s=ev["stall_s"], commit_s=ev["cost_s"],
                   stall_event_ms=a.elapsed_time(b),
                   relayout_s=(ev["measured"].get("I-b", 0.0)
                               - ev["bg_migrate_s"] - ev["bg_precompile_s"]),
                   staged=ev["staged"], bg_migrate_s=ev["bg_migrate_s"],
                   bg_precompile_s=ev["bg_precompile_s"],
                   bg_blocks=ev["bg_blocks"], delta_blocks=ev["delta_blocks"],
                   staged_ticks=len(during), staged_wall_s=ev["staged_wall_s"],
                   max_tick_ms=max(during) * 1e3)
    out.update(drop_s=dropped["s"], dropped=dropped["n"])
    after = [eng.step()["dt"] for _ in range(20)]
    out.update(max_tick_after_ms=max(after) * 1e3,
               median_tick_after_ms=statistics.median(after) * 1e3)
    while eng.has_work():
        eng.step()
    if any(len(r.tokens_out) != r.max_new for r in eng.finished):
        raise SystemExit("a request lost tokens across the switch")
    eng.pool.check_invariants()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--baseline", default=None, metavar="DIR")
    ap.add_argument("--space", action="store_true")
    args = ap.parse_args()
    if args.baseline:
        return turns(args)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build_all
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"device: {card} | torch {torch.__version__}", flush=True)
    build_all()
    cfg = get_config("starcoder2-3b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    if args.space:
        return space(torch, cfg, params, card)
    rows = []
    for name, (start, change, n_live) in SWITCHES.items():
        for rep in range(args.reps):
            for staged in (False, True) if rep % 2 == 0 else (True, False):
                r = one(torch, cfg, params, start, change, n_live, staged,
                        seed=rep)
                r.update(switch=name, mode="staged" if staged
                         else "stop-the-world", rep=rep)
                rows.append(r)
                bg = (f", bg migrate {r['bg_migrate_s'] * 1e3:.3f} ms and "
                      f"captures {r['bg_precompile_s']:.3f} s over "
                      f"{r['staged_ticks']} ticks ({r['bg_blocks']} blocks, "
                      f"delta {r['delta_blocks']}), committed "
                      f"{'staged' if r['staged'] else 'stop-the-world'}"
                      if staged else "")
                print(f"{name:16s} {r['mode']:14s} rep {rep}: stall "
                      f"{r['stall_s'] * 1e3:9.3f} ms; commit "
                      f"{r['commit_s'] * 1e3:9.3f} ms wall, "
                      f"{r['stall_event_ms']:9.3f} ms between CUDA events, "
                      f"relayout {r['relayout_s'] * 1e3:.3f} ms (dropping "
                      f"{r['dropped']} old steps {r['drop_s'] * 1e3:.3f} ms)"
                      f"{bg}; "
                      f"longest tick {r['max_tick_ms']:.2f} ms against "
                      f"{r['tick_ms_before']:.2f} ms before; the 20 ticks "
                      f"after: longest {r['max_tick_after_ms']:.2f} ms, "
                      f"median {r['median_tick_after_ms']:.2f} ms",
                      flush=True)
                torch.cuda.empty_cache()
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"card": card, "rows": rows}, indent=1))
    print(card_line(), flush=True)


def space(torch, cfg, params, card):
    """``warm_start(space)`` at every prompt length max_seq admits."""
    from collections import Counter
    from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                     serving_knob_space)
    sp = serving_knob_space(max_batch_ceiling=8, include_batches=(4,),
                            family=cfg.family)
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=4),
                        max_seq=1024, device="cuda")
    eng.warm_start(sp)
    st = eng.capture_stats
    kinds = Counter(k[0] for k in eng._steps._d)
    print(f"warm_start(space), max_seq 1024, prompts 1-1024: "
          f"{st['steps']} steps {dict(kinds)}, step cache capacity "
          f"{eng._steps.capacity}, evictions {eng._steps.evictions}, "
          f"{st['capture_s']:.2f} s of captures, graph memory "
          f"{st['graph_bytes'] / 2 ** 20:.1f} MiB on {card}", flush=True)
    print(card_line(), flush=True)


def turns(args):
    """Baseline, this tree, this tree, baseline: each a fresh process of
    this script with one repetition, the baseline's with DIR/src first on
    the import path (the model and the card are the same for all four)."""
    for tag in ("baseline", "tree", "tree", "baseline"):
        env = dict(os.environ)
        if tag == "baseline":
            env["PYTHONPATH"] = str(Path(args.baseline).resolve() / "src")
        print(f"--- {tag} ---", flush=True)
        subprocess.run([sys.executable, __file__, "--reps", "1"],
                       env=env, check=True)


if __name__ == "__main__":
    main()
