"""Serving launcher of the port: continuous-batching engine, optionally
self-tuning, on the CUDA device by default.

  # full-width starcoder2-3b on the card, max_batch=4:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 4

  # full-width falcon-mamba-7b (ssm family, selective-scan kernel):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b

  # full-width zamba2-1.2b (hybrid family: mamba2 blocks through the scan
  # kernel at N = 64, a shared attention block through the flash and
  # paged-attention kernels), self-tuned and warm-started from a tuning
  # store that every run reads and adds to:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --selftune --tuning-store /path/to/store

  # full-width phi-3-vision-4.2b (vlm family: 32 layers of 32 heads of
  # hd 96; served from tokens only, as the JAX engine serves it):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi-3-vision-4.2b

  # llama4-scout-17b-a16e (moe family: 16 routed experts a layer, top-1,
  # paged KV) does not fit one card at its 48 layers (203 GB of bf16
  # weights); reduced, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --reduced --device cpu

  # self-tuning (the tuner learns the serving setting online and applies
  # it by staged or stop-the-world reconfiguration), with a Chrome trace
  # (+ PATH.audit.jsonl, the tuner's decisions) and the attribution panel:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --selftune --trace /tmp/serve.trace.json

  # reduced config on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --reduced --device cpu --selftune
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --reduced --device cpu --selftune --tuning-store /tmp/store
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi-3-vision-4.2b --reduced --device cpu

Weights are random, drawn from ``--seed``.  ``--tuning-store DIR`` (with
``--selftune``) keeps the JAX package's store layout, so either package
reads a store the other wrote: the run starts from the golden incumbent
of the nearest signature, the tuner absorbs that signature's observations
and skips init settings, and on exit the store is compacted and its
``GOLDEN.json`` rewritten.  The dense, moe, vlm, ssm and hybrid families
are served (vlm from tokens only); an encoder arch exits before its model
is built: it has no decode step, as in the JAX package's launcher.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.registry import get_config
from repro_torch.core.tuner import TunerConfig, TuningManager
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs import (MetricsRegistry, Tracer, write_audit_jsonl,
                             write_chrome_trace)
from repro_torch.obs.report import format_attribution, time_attribution
from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                 SERVING_RELAYOUT_KNOBS, ServingEngine,
                                 ServingObjective, serve_loop,
                                 serving_knob_space)
from repro_torch.serving.workload import make_trace
from repro_torch.store import TuningStore, lookup, signature_from_trace


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


def selftune_manager(engine, space, setting: dict, *, window: int = 40,
                     init_settings: int = 5, seed: int = 0,
                     drift_z: float = 3.0, slo_s: float = 3.0,
                     tracer=None, store=None,
                     signature=None) -> TuningManager:
    """The tuner of ``--selftune``: a TuningManager over ``space`` that
    scores the engine with the SLO-penalized ServingObjective, classifies
    the pool knobs as Type I-b, closes a window after ``window`` quanta or
    2 s of tick time, and amortizes switch costs over a horizon learned
    from observed load drift (20 s before the first drift).  With a
    ``store`` and ``signature`` it warm-starts from the store and writes
    what it learns back."""
    return TuningManager(
        space, setting,
        TunerConfig(eps=1e-6, a=window, b=init_settings, seed=seed,
                    drift_z=drift_z, window_time_s=2.0,
                    amortize_horizon_s=20.0, adapt_horizon=True),
        objective=ServingObjective(engine, slo_p99_s=slo_s),
        reconfig_knob_classes={"mesh_knobs": SERVING_RELAYOUT_KNOBS},
        tracer=tracer, store=store, signature=signature)


def open_store(path: str, engine, cfg, max_seq: int, trace,
               duration_s: float, setting: dict):
    """The tuning store at ``path``, this run's signature, and the start
    setting: the golden incumbent of the nearest signature (applied to
    ``engine``) when the store holds observations, else ``setting``."""
    store = TuningStore(path)
    sig = signature_from_trace(cfg, engine.pool.kind, max_seq, trace,
                               duration_s)
    entry, _, tier = (lookup(store.build_golden(), sig)
                      if store.read_records(kinds=("obs",))
                      else (None, None, None))
    if entry is None:
        print(f"tuning-store: no golden entry for {sig.key}", flush=True)
        return store, sig, setting
    golden = {k: tuple(v) if isinstance(v, list) else v
              for k, v in entry["incumbent"]["setting"].items()}
    setting = dict(setting, **golden)
    engine.reconfigure(setting)
    print(f"tuning-store: golden incumbent {golden} ({tier} match, "
          f"{entry['n_obs']} obs) -> start setting", flush=True)
    return store, sig, setting


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
                    help="tune serving knobs online while serving")
    ap.add_argument("--tuning-store", default=None, metavar="DIR",
                    help="fleet tuning store (with --selftune): warm-start "
                         "from it and add this run's observations")
    ap.add_argument("--scenario", default="poisson",
                    choices=("poisson", "bursty", "diurnal", "mixed_lengths",
                             "shared_prefix", "long_prompt"),
                    help="traffic shape")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="mean request arrival rate (req/s)")
    ap.add_argument("--duration", type=float, default=4.0,
                    help="length of the arrival window (s)")
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--window", type=int, default=40,
                    help="tuner iterations per setting window (a)")
    ap.add_argument("--init-settings", type=int, default=5,
                    help="random settings in the tuner init phase (b)")
    ap.add_argument("--slo", type=float, default=3.0,
                    help="p99 latency SLO (s) for the serving objective")
    ap.add_argument("--drift-z", type=float, default=3.0,
                    help="load-drift z-score threshold (0 disables the "
                         "EWMA re-search trigger)")
    ap.add_argument("--cold", action="store_true",
                    help="skip the startup kernel build and warm-up "
                         "(reconfiguration costs then include captures)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON (Perfetto-"
                         "loadable) of the run, plus PATH.audit.jsonl with "
                         "the tuner's decision/reconfig audit when "
                         "--selftune is on")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.prompt_len + args.gen > args.max_seq:
        raise SystemExit(f"--prompt-len + --gen ({args.prompt_len}+{args.gen})"
                         f" must fit in --max-seq ({args.max_seq})")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    device = resolve_device(args.device)
    params = lm.init_params(cfg, args.seed, device=device)
    space = serving_knob_space(max_batch_ceiling=max(8, args.batch),
                               include_batches=(args.batch,),
                               family=cfg.family)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=args.batch)
    engine = ServingEngine(params, cfg, setting, max_seq=args.max_seq,
                           device=device)
    trace_kw, max_prompt = trace_kwargs(args.scenario, args.prompt_len,
                                        args.gen, args.max_seq)
    if not args.cold:
        t0 = time.perf_counter()
        # fixed mode never leaves its setting — warm only its steps
        engine.warm_start(space if args.selftune else None,
                          max_prompt=max_prompt)
        print(f"warm-start: {len(engine._steps)} step callables and the "
              f"kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    trace = make_trace(args.scenario, args.rate, args.duration,
                       vocab=cfg.vocab_size, seed=args.seed, **trace_kw)
    store = sig = None
    if args.tuning_store and args.selftune:
        store, sig, setting = open_store(args.tuning_store, engine, cfg,
                                         args.max_seq, trace, args.duration,
                                         setting)
    # the tracer goes on after warm-start, so the attribution panel covers
    # the serving run, not startup (a --cold run still shows its captures:
    # they fire inside ticks and reconfiguration windows as exec.build)
    tracer = None
    if args.trace:
        tracer = Tracer()
        engine.set_tracer(tracer, MetricsRegistry(enabled=True))
    tuner = None
    if args.selftune:
        tuner = selftune_manager(
            engine, space, setting, window=args.window,
            init_settings=args.init_settings, seed=args.seed,
            drift_z=args.drift_z, slo_s=args.slo, tracer=tracer,
            store=store, signature=sig)
        ws = tuner.warm_start_info
        if ws is not None:
            print(f"tuning-store: warm-start absorbed {ws['absorbed_obs']} "
                  f"obs (tier={ws['tier']}, skipped "
                  f"{ws['init_settings_skipped']} init settings"
                  f"{', READ-ONLY' if ws['read_only'] else ''})", flush=True)
    mode = "selftune" if args.selftune else f"fixed(max_batch={args.batch})"
    print(f"arch={cfg.name} family={cfg.family} pool={engine.pool.kind} "
          f"device={device} scenario={args.scenario} rate={args.rate}rps "
          f"duration={args.duration}s mode={mode}")
    stats = serve_loop(engine, trace, tuner, verbose=True)
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
    if args.selftune:
        print(f"reconfigurations: {stats['reconfig_count']} "
              f"({stats['reconfig_total_s']:.2f}s total), "
              f"final setting: {stats['final_setting']}")
    if store is not None:
        # release the shared lock, fold this run's segment in, refresh the
        # golden table: the next process warm-starts from all of it
        tuner.close_store()
        compacted = store.compact()
        table = store.write_golden()
        print(f"tuning-store: {len(table['entries'])} golden entries -> "
              f"{store.golden_path}"
              f"{'' if compacted else ' (compaction skipped: store busy)'}",
              flush=True)
    if tracer is not None:
        audit = tuner.audit if tuner is not None else None
        attr = time_attribution(tracer, stats["wall_s"], audit=audit)
        stats["time_attribution"] = attr
        print(format_attribution(attr), flush=True)
        n_ev = write_chrome_trace(args.trace, tracer,
                                  process_name=f"serve:{cfg.name}")
        print(f"trace: {n_ev} events -> {args.trace} "
              f"(load in https://ui.perfetto.dev)", flush=True)
        if audit is not None and audit.records:
            audit_path = args.trace + ".audit.jsonl"
            n_rec = write_audit_jsonl(audit_path, audit)
            print(f"tuning audit: {n_rec} records -> {audit_path}",
                  flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(stats, f, indent=1, default=str)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
