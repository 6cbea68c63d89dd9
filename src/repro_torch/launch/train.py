"""Training launcher of the port, on the CUDA device by default.

  # full-width starcoder2-3b on the card, 4 x 512 tokens a step:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --batch 4 --seq 512 --steps 30

  # full-width phi-3-vision-4.2b (vlm family) on the card; its batches
  # are text, as the JAX package's LMJob draws them (frontend/proj gets a
  # zero gradient):
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch phi-3-vision-4.2b --batch 4 --seq 512 --steps 10

  # full-width zamba2-1.2b (hybrid: mamba2 + the shared attention block)
  # or falcon-mamba-7b (ssm) on the card; the scan's forward and backward
  # kernels (falcon-mamba-7b's 64 layers need ~73 GB of weights and Adam
  # moments: it fits one H100 only at reduced depth, as chip_smoke.py runs
  # it); --reduced --device cpu runs either on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --batch 4 --seq 512 --steps 10

  # self-tuning (the paper's online tuner over microbatches, remat,
  # gradient compression, staleness and k_chunk), with a Chrome trace and
  # the time-attribution panel:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --device cpu --self-tune --trace /tmp/train.trace.json

  # reduced config on the CPU (plain PyTorch versions of the kernels),
  # checkpointing every 10 steps and resuming from the latest:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --device cpu --steps 50 --ckpt-dir /tmp/ck --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --device cpu --steps 50 --ckpt-dir /tmp/ck --resume

Under ``torchrun --nproc-per-node N`` it runs one process a device (NCCL
on the cards, gloo with ``--device cpu``): each rank holds its shards of
the state, the batch is split over the data axes, rank 0 alone prints,
tunes and writes the checkpoints and the trace, and ``--self-tune`` adds
the ``mesh_split`` knob (Type I-b: ODMR or the checkpoint baseline)::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch starcoder2-3b --reduced --device cpu --self-tune --steps 60

Without torchrun's environment it runs on one device.

``--self-tune`` turns on the tuner; otherwise the default setting runs
fixed.  Weights are random, drawn from ``--seed``.  The dense, moe, vlm,
ssm and hybrid families train (moe: the router's load-balancing loss,
weighted by ``router_aux_weight``, enters the loss; each layer's expert
tensors are autograd leaves of their own; ssm and hybrid: the selective
scan's backward kernel on the card).  An encoder arch
(hubert) exits before its model is built: the job draws token batches
(``lm_batch_iterator``, as the JAX package's LMJob does) and an encoder
reads frames; ``ps.stepfn.build_train_step`` trains it on frame batches
(``data.synthetic.synthetic_batch``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.core.tuner import TunerConfig, TuningManager
from repro_torch.launch.mesh import init_distributed, launched, world
from repro_torch.obs import NOP_TRACER, Tracer, write_chrome_trace
from repro_torch.obs.report import format_attribution, time_attribution
from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob, lm_knob_space
from repro_torch.ps.trainer import SelfTuningLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eps", type=float, default=0.05,
                    help="convergence threshold on CE loss")
    ap.add_argument("--self-tune", action="store_true")
    ap.add_argument("--tuner-a", type=int, default=8)
    ap.add_argument("--tuner-b", type=int, default=6)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event JSON (Perfetto-"
                         "loadable) of the run")
    args = ap.parse_args(argv)

    if launched():
        init_distributed(args.device or "cuda")
    try:
        run(args)
    finally:
        if launched():
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args):
    lead = world()[0] == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encoder":
        raise SystemExit(
            f"{cfg.name}: the LM job feeds token batches and an encoder "
            f"reads frames; train it through ps.stepfn.build_train_step on "
            f"data.synthetic.synthetic_batch frame batches")
    job = LMJob(cfg, batch=args.batch, seq=args.seq, seed=args.seed,
                device=args.device)
    job.eps = args.eps
    say(f"arch={cfg.name} params={cfg.n_params():,} device={job.device} "
        f"ranks={job.n_devices}")

    ckpt = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                              placement=job.placement)
            if args.ckpt_dir else None)
    setting = dict(DEFAULT_LM_SETTING)
    if job.n_devices > 1:                 # the whole world as data ranks
        setting["mesh_split"] = f"{job.n_devices}x1"
    state = job.init_state(setting, args.seed)
    if args.resume and ckpt is not None:
        try:
            ms, specs = job.placement()
            state, meta = ckpt.restore_latest(state, ms=ms, specs=specs)
            say(f"resumed from step {meta['step']}")
        except FileNotFoundError:
            say("no checkpoint found; starting fresh")

    tracer = Tracer() if args.trace and lead else None
    t_run0 = time.perf_counter()
    if args.self_tune:
        space = lm_knob_space(job.n_devices)
        tuner = TuningManager(space, setting, TunerConfig(
            eps=args.eps, a=args.tuner_a, b=args.tuner_b, seed=args.seed))
        loop = SelfTuningLoop(tuner, job.step_builder, job.state_adapter,
                              checkpoint_manager=ckpt, tracer=tracer)
        res, state = loop.run(state, job.batches(args.seed),
                              max_iters=args.steps, verbose=True)
        say(f"done: iters={res.iterations} wall={res.wall_time_s:.1f}s "
            f"loss={res.final_loss:.4f} converged={res.converged} "
            f"reconfig_s={res.reconfig_total_s:.1f}")
        if lead:
            say(f"final setting: {tuner.current}")
            rep = tuner.progress_report()
            say(f"progress indicator: remaining ~{rep['remaining_iters']:.0f}"
                f" iters / {rep['remaining_time_s']:.1f}s")
    else:
        tr = tracer or NOP_TRACER
        step = job.step_builder(setting)
        bi = job.batches(args.seed)
        losses = []
        t0 = time.perf_counter()
        for it in range(1, args.steps + 1):
            with tr.span("train.step", it=it):
                state, m = step(state, next(bi))
                losses.append(float(m["loss"]))
            if ckpt is not None:
                ckpt.maybe_save(state, it, {"loss": losses[-1]})
            if it % 20 == 0:
                say(f"[{it}] loss={np.mean(losses[-20:]):.4f} "
                    f"({(time.perf_counter()-t0)/it*1000:.0f} ms/it)")
            # the loss is averaged over the ranks: every rank stops together
            if np.mean(losses[-8:]) <= args.eps and len(losses) >= 8:
                say("converged")
                break
        say(f"done: iters={len(losses)} loss={losses[-1]:.4f}")
    if tracer is not None:
        wall = time.perf_counter() - t_run0
        audit = tuner.audit if args.self_tune else None
        attr = time_attribution(tracer, wall, audit=audit,
                                extra_keys=("train_step",))
        say(format_attribution(attr))
        n_ev = write_chrome_trace(args.trace, tracer,
                                  process_name=f"train:{cfg.name}")
        say(f"trace: {n_ev} events -> {args.trace} "
            f"(load in https://ui.perfetto.dev)")
    say("OK")


if __name__ == "__main__":
    main()
