"""Serving launcher of the port: continuous-batching engine at a fixed
setting, on the CUDA device by default.

  # full-width starcoder2-3b on the card, max_batch=4:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 4

  # reduced config on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --reduced --device cpu

Weights are random, drawn from ``--seed``.  ``--selftune`` and
``--tuning-store`` come with a later slice of the port and raise.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                 serve_loop)
from repro_torch.serving.workload import make_trace


def trace_kwargs(scenario: str, prompt_len: int, gen: int, max_seq: int):
    """Per-scenario generator arguments that keep every request inside
    ``max_seq``, and the longest prompt they can produce (the JAX
    launcher's rules)."""
    kw = {"prompt_lens": (4, prompt_len), "max_news": (4, gen)}
    max_prompt = prompt_len
    cap = max_seq - gen
    if scenario == "mixed_lengths":
        kw["long_lens"] = (min(32, cap), min(56, cap))
        max_prompt = max(max_prompt, kw["long_lens"][1])
    elif scenario == "long_prompt":
        kw["prompt_lens"] = (min(40, cap - 1), min(68, cap))
        max_prompt = max(max_prompt, kw["prompt_lens"][1])
    elif scenario == "shared_prefix":
        kw["prefix_len"] = min(32, max(cap - 8, 1))
        max_prompt = max(max_prompt, kw["prefix_len"] + 8)
    return kw, max_prompt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed max_batch ceiling")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selftune", action="store_true",
                    help="not ported yet (later slice)")
    ap.add_argument("--tuning-store", default=None, metavar="DIR",
                    help="not ported yet (later slice)")
    ap.add_argument("--scenario", default="poisson",
                    choices=("poisson", "bursty", "diurnal", "mixed_lengths",
                             "shared_prefix", "long_prompt"),
                    help="traffic shape")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="mean request arrival rate (req/s)")
    ap.add_argument("--duration", type=float, default=4.0,
                    help="length of the arrival window (s)")
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--cold", action="store_true",
                    help="skip the startup kernel build and warm-up")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.selftune or args.tuning_store:
        raise NotImplementedError(
            "--selftune and --tuning-store are not ported yet: they come "
            "with the tuning-stack slice of the port")
    if args.prompt_len + args.gen > args.max_seq:
        raise SystemExit(f"--prompt-len + --gen ({args.prompt_len}+{args.gen})"
                         f" must fit in --max-seq ({args.max_seq})")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, args.seed, device=device)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=args.batch)
    engine = ServingEngine(params, cfg, setting, max_seq=args.max_seq,
                           device=device)
    trace_kw, max_prompt = trace_kwargs(args.scenario, args.prompt_len,
                                        args.gen, args.max_seq)
    if not args.cold:
        t0 = time.perf_counter()
        engine.warm_start(max_prompt=max_prompt)
        print(f"warm-start: {len(engine._steps)} step callables and the "
              f"kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    trace = make_trace(args.scenario, args.rate, args.duration,
                       vocab=cfg.vocab_size, seed=args.seed, **trace_kw)
    print(f"arch={cfg.name} family={cfg.family} device={device} "
          f"scenario={args.scenario} rate={args.rate}rps "
          f"duration={args.duration}s mode=fixed(max_batch={args.batch})")
    stats = serve_loop(engine, trace)
    print(f"served {stats['completed']}/{stats['requests']} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.1f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")
    if stats["p50_latency_s"] is not None:
        print(f"latency p50={stats['p50_latency_s']:.2f}s "
              f"p99={stats['p99_latency_s']:.2f}s "
              f"ttft p50={stats['p50_ttft_s']:.2f}s")
    if stats["prefill_tokens_total"]:
        saved = (stats["prefill_tokens_total"]
                 - stats["prefill_tokens_computed"])
        print(f"prefill: {stats['prefill_tokens_computed']}/"
              f"{stats['prefill_tokens_total']} tokens computed "
              f"({saved} shared, {stats['cow_copies']} COW copies)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(stats, f, indent=1, default=str)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
