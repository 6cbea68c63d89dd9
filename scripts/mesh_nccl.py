#!/usr/bin/env python3
"""The mesh over NCCL on four cards: sharded training and Type I-b.

    torchrun --nproc-per-node 4 scripts/mesh_nccl.py [--layers 30] \\
        [--only train|engine|tp]
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
3. The serving engine on 2x2 (``ServingEngine(ms=...)``: every step a
   CUDA graph on the card, its all-gathers captured in it), 8 slots,
   max_seq 1024, blocks of 16, prefix sharing, over the shared-prefix
   trace of ``chip_smoke.py``'s phase 6: driven tick by tick (no wall
   clock) with the parameters whole, then with fsdp shards and a
   stop-the-world max_batch 8 -> 4 and a staged 4 -> 8 mid-run, then
   through ``serve_loop`` (lockstep: rank 0's clock and stop broadcast).
   Every rank also drives the single-device engine (``ms=None``) on the
   same requests.  Each arm: every rank's tokens and the digest of its
   final pool and block tables gathered to rank 0, which requires them
   equal on the four ranks; the requests whose tokens equal the
   single-device engine's, and every other request held to them
   tie-aware (``tie_aware``); the decode-step time (the host clock around
   each step and its synchronize, rank 0's) beside the single-device
   engine's; the steps captured as graphs.  ``--probe`` then times one
   decode step's graph replay (8 slots at position 320) of the
   single-device engine and of the 2x2 engine with whole parameters, the
   ranks' hosts aligned by a barrier before each replay (CUDA events,
   rank 0), and a bare all-gather of its logits rows over the data axis,
   eager and captured.
4. Tensor parallelism (``--only tp``; also in the default run): the train
   step of section 1 on 1x1 (each rank alone, the single-device step),
   4x1 (the per-layer pull over data alone), 1x4 and 2x2, the last two
   meshes' layers tensor-parallel over ``model`` with the per-layer pull
   (``sharding.tp_plan``; starcoder2-3b's 24 query heads over 4 or 2
   ranks); each mesh's losses against 1x1's (within 2e-3), its step ms
   and the allocated GB of rank 0 after each step.  The same with the
   int8 push on 1x1, 1x4 and 2x2 (the shards quantized with the whole
   leaf's scale), against 1x1's int8 losses, with the sizes of the
   blocks rank 0 quantized in one step.  Then the serve steps on 2x2
   (``build_prefill_step``, ``build_decode_step`` over the dense cache),
   fsdp and tp_only: 8 prompts of 320 tokens, 16 greedy steps; every
   request's tokens against the single-device ``lm.prefill`` /
   ``lm.decode_step``'s, tie-aware, and each step's ms.  ``--profile``
   adds two steps of each train split under torch.profiler: rank 0's
   wall ms a step, kernel ms a step (the busy share) and the NCCL, GEMM,
   flash, quant and random-number kernels' ms; and each rank's host
   (``host``): the ms a step inside operators on any thread, blocked in
   synchronizations and scalar reads, in kernel launches and in the
   collectives' host calls, and its top operators by host ms.
   ``--quick`` runs only the train steps of 4x1, 2x2 and 1x4 (to time two
   trees in one call: parent, change, change, parent).

Rank 0 prints the card's name and power limit, one JSON line and OK.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
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
TP_SPLITS = ("1x1", "4x1", "1x4", "2x2")
TP_INT8_SPLITS = ("1x1", "1x4", "2x2")
TP_LOSS_TOL = 2e-3                 # tests/test_torch_mesh.py's MESH_LOSS_TOL
TP_P, TP_STEPS, TP_MAX = 320, 16, 1024


def bf16_steps(x: float) -> float:
    """One bf16 step at |x| (at least that of 1)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1.0))) - 7)


def tie_aware(cfg, params, prompt, ref, got) -> bool:
    """Equal greedy tokens, or at the first mismatch the one-card prefill
    logits over the prompt and ``ref[:t]`` rank ``got[t]`` within four
    bf16 steps of ``ref[t]`` (the continuations then legitimately
    differ), as tests/test_torch_engine_mesh.py holds them."""
    from repro_torch.models import lm
    for t, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        seq = list(prompt) + list(ref[:t])
        with torch.no_grad():
            lg, _ = lm.prefill(params, torch.tensor(
                [seq], device=params["final_norm"]["scale"].device), cfg)
        lg = lg[0, -1].float()
        return float(lg[a] - lg[b]) <= 4 * bf16_steps(float(lg[a]))
    return len(ref) == len(got)


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


@contextlib.contextmanager
def quant_blocks():
    """The sizes of the blocks ``ps.compression`` quantizes while active
    ({numel: count}, this rank's)."""
    from repro_torch.ps import compression
    seen, real = {}, compression.quantize

    def counted(x, u, *, block=256):
        seen[block] = seen.get(block, 0) + 1
        return real(x, u, block=block)

    compression.quantize = counted
    try:
        yield seen
    finally:
        compression.quantize = real


def splits(args, cfg, device, say, names=SPLITS, compression="none"):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    out = {}
    for split in names:
        job = LMJob(cfg, batch=args.batch, seq=args.seq, device=device)
        setting = dict(DEFAULT_LM_SETTING, mesh_split=split,
                       compression=compression)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = job.init_state(setting, seed=0)
        step = job.step_builder(setting)
        batches = job.batches(0)
        reset_launches()
        losses, ms, alloc = [], [], []
        for i in range(args.steps):
            batch = next(batches)
            with Clock(device) as c, quant_blocks() as blocks:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            ms.append(round(c.s * 1e3, 2))
            if device.type == "cuda":
                alloc.append(round(torch.cuda.memory_allocated() / 1e9, 3))
        out[split] = {"losses": losses, "wall_ms": ms, "alloc_gb": alloc,
                      "peak_gb": round(peak_gb(device), 2),
                      "launches": {k: v for k, v in LAUNCHES.items() if v}}
        if blocks:
            out[split]["quant_blocks"] = blocks
        if getattr(args, "profile", False) and device.type == "cuda":
            state, out[split]["profile"] = profiled(step, state, batches)
            out[split]["alloc_gb"].append(
                round(torch.cuda.memory_allocated() / 1e9, 3))
            say(f"mesh[{split} {compression}] profile (ms a step): "
                f"{out[split]['profile']}")
        say(f"mesh[{split} {compression}]: {cfg.n_layers} layers, "
            f"{args.batch} x {args.seq} tokens: losses {losses}, wall ms "
            f"{ms}, allocated GB after each step {out[split]['alloc_gb']}, "
            f"peak {out[split]['peak_gb']} GB (fullest rank), launches a "
            f"rank {out[split]['launches']}"
            + (f", quantized blocks a step (rank 0) {blocks}" if blocks
               else ""))
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


def engine_trace(cfg):
    """``chip_smoke.py``'s ``dense_trace``: the shared_prefix trace plus
    one prompt that is a whole template (a copy-on-write at admission)."""
    from repro_torch.serving import Request
    from repro_torch.serving.workload import make_trace
    trace = make_trace("shared_prefix", 400.0, 0.04, vocab=cfg.vocab_size,
                       seed=4, prefix_len=256, tail_lens=(16, 96),
                       max_news=(32, 32))
    trace.append(Request(rid=len(trace), prompt=trace[0].prompt[:256].copy(),
                         max_new=32, arrival_s=trace[0].arrival_s))
    return trace


class DecodeSpans:
    """A tracer for the engine that counts its decode and verify steps."""

    def __init__(self):
        self.steps = 0

    @contextlib.contextmanager
    def span(self, name, **_):
        if name in ("serve.decode", "decode.verify"):
            self.steps += 1
        yield


def pool_digest(eng) -> str:
    """sha256 of the pool's tensors (every byte) and block tables."""
    h = hashlib.sha256()
    state = eng.pool.kv if eng.pool.kind == "paged" else eng.pool.state
    for k in sorted(state):
        t = state[k].detach().contiguous()
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    if eng.pool.kind == "paged":
        h.update(eng.pool.tables.tobytes())
    return h.hexdigest()


def engines(args, cfg, device, say):
    """Section 3: the engine on 2x2 against the single-device engine."""
    from repro_torch.core.reconfig import plan as rc_plan
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed.sharding import shard
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.models import lm
    from repro_torch.ps.stepfn import serve_param_specs
    from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                     SERVING_RELAYOUT_KNOBS, ServingEngine,
                                     serve_loop)
    from repro_torch.serving.engine import Request
    ms = make_meshspec(2, 2)
    whole_p = lm.init_params(cfg, seed=0, device=device)
    specs = serve_param_specs(cfg, ms)
    shards = tree_map(lambda x, sp: shard(x, sp, ms).clone(), whole_p,
                      specs)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                   cache_dtype="bf16", prefix_share=True)
    max_seq = 1024 if not args.reduced else 512
    trace = engine_trace(cfg)

    def relayout(e, tick):
        if tick == 4:
            e.apply_plan(rc_plan(e.setting, {**e.setting, "max_batch": 4},
                                 mesh_knobs=SERVING_RELAYOUT_KNOBS))
        elif tick > 4 and e.n_slots == 4 and e._staged is None:
            e.begin_reconfig(rc_plan(e.setting, {**e.setting, "max_batch": 8},
                                     mesh_knobs=SERVING_RELAYOUT_KNOBS))

    arms = {"single": (None, whole_p, None, None),
            "2x2 whole": (ms, whole_p, None, None),
            "2x2 fsdp relayout": (ms, shards, specs, relayout),
            "2x2 fsdp serve_loop": (ms, shards, specs, "loop")}
    out, ref = {}, None
    for name, (m, params, pspecs, how) in arms.items():
        spans = DecodeSpans()
        eng = ServingEngine(params, cfg, setting, max_seq=max_seq,
                            device=device, ms=m, param_specs=pspecs,
                            tracer=spans)
        reqs = [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                        arrival_s=r.arrival_s) for r in trace]
        with Clock(device) as c:
            if how == "loop":
                serve_loop(eng, reqs)
            else:
                for r in reqs:
                    eng.submit(r)
                tick = 0
                while eng.has_work():
                    eng.step()
                    tick += 1
                    if callable(how):
                        how(eng, tick)
        toks = {r.rid: r.tokens_out for r in eng.finished}
        graphs = sum(hasattr(v, "graph") for v in eng._steps._d.values())
        res = {"s": round(c.s, 3), "decode_steps": spans.steps,
               "decode_ms": round(eng.decode_time_s * 1e3
                                  / max(spans.steps, 1), 3),
               "graphs": graphs, "steps": len(eng._steps),
               "slots": eng.n_slots,
               "staged_commits": sum(ev["staged"] for ev in
                                     eng.take_reconfig_events())}
        if m is not None:
            seen = [None] * dist.get_world_size()
            dist.all_gather_object(seen, (toks, pool_digest(eng)))
            res["ranks_same"] = all(x == seen[0] for x in seen)
        if ref is None:
            ref = toks
        res["complete"] = (len(toks) == len(trace) and all(
            len(t) == r.max_new for r, t in zip(trace, (toks[r.rid]
                                                        for r in trace))))
        res["same_as_single"] = sum(toks[rid] == t for rid, t in ref.items())
        prompts = {r.rid: r.prompt for r in trace}
        res["tie_aware"] = all(tie_aware(cfg, whole_p, prompts[rid], t,
                                         toks[rid]) for rid, t in ref.items())
        out[name] = res
        say(f"engine[{name}]: {len(toks)} requests in {c.s:.3f}s (captures "
            f"included), {spans.steps} decode steps, decode "
            f"{res['decode_ms']} ms a step, {graphs}/{res['steps']} steps "
            f"captured as CUDA graphs, {res['staged_commits']} staged "
            f"commits, {eng.n_slots} slots at the end; every rank's tokens "
            f"and pool "
            f"{'the same' if res.get('ranks_same', True) else 'DIFFER'}; "
            f"{res['same_as_single']}/{len(ref)} requests the single-device "
            f"engine's tokens, the rest "
            f"{'tie-aware' if res['tie_aware'] else 'NOT tie-aware'}")
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if dist.get_rank() == 0 and not all(
            r.get("ranks_same", True) and r["complete"] and r["tie_aware"]
            for r in out.values()):
        raise SystemExit("the engine's ranks disagree, left a request or "
                         "served a token no tie explains")
    if args.probe:
        out["probe"] = probe(cfg, device, say, ms, whole_p, setting, max_seq)
    return out


PROFILE_KINDS = (("nccl", r"nccl|ncclDevKernel"),
                 ("gemm", r"nvjet|gemm|cutlass|sm90_xmma|Kernel2"),
                 ("flash", r"flash"),
                 ("quant", r"quantize|dequantize"),
                 ("rng", r"philox|distribution_elementwise|uniform"))
# the host's operators by kind: blocked waiting for the card (a
# synchronization, a copy to the host, a scalar read), launching kernels,
# and the collectives' host calls (NCCL's are asynchronous)
HOST_KINDS = (("blocked", r"^cuda(Stream|Device|Event)Synchronize$|"
                          r"^aten::_local_scalar_dense$|^cudaMemcpy$"),
              ("launch", r"^cu(da)?LaunchKernel"),
              ("collective", r"^c10d::|^nccl:|^record_param_comms$"))


def host_profile(prof, steps: int, wall: float) -> dict:
    """This rank's host time a step from ``prof``'s CPU events."""
    import re
    ev = [e for e in prof.key_averages() if "CUDA" not in str(e.device_type)]
    res = {"wall": round(wall, 2),
           "ops": round(sum(e.self_cpu_time_total for e in ev)
                        / steps / 1e3, 2)}
    for kind, pat in HOST_KINDS:
        sel = [e for e in ev if re.search(pat, e.key)]
        res[kind] = round(sum(e.self_cpu_time_total for e in sel)
                          / steps / 1e3, 2)
        res[f"n_{kind}"] = sum(e.count for e in sel) // steps
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:6]
    res["top"] = [(e.key, round(e.self_cpu_time_total / steps / 1e3, 2),
                   e.count // steps) for e in top]
    return res


def profiled(step, state, batches, steps=2):
    """Wall ms a step against kernel ms a step (all kernels, and the
    NCCL, GEMM and flash kernels) under torch.profiler; every rank runs
    the steps."""
    import re

    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, next(batches))
            float(m["loss"])
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
    res = {"wall": round(wall, 2),
           "kernels": round(sum(dev_us(e) for e in kernels)
                            / steps / 1e3, 2),
           "launches": sum(e.count for e in kernels) // steps}
    for kind, pat in PROFILE_KINDS:
        res[kind] = round(sum(dev_us(e) for e in kernels
                              if re.search(pat, e.key)) / steps / 1e3, 2)
    res["busy"] = round(res["kernels"] / wall, 3)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host_profile(prof, steps, wall))
    res["host"] = hosts
    return state, res


def tp_arm(args, cfg, device, say):
    """Section 4: the tensor-parallel train step against 1x1, then the
    serve steps on 2x2 against one card."""
    if args.quick:
        return {"train": splits(args, cfg, device, say, SPLITS)}
    out = {}
    for comp, names in (("none", TP_SPLITS), ("int8", TP_INT8_SPLITS)):
        key = "train" if comp == "none" else f"train_{comp}"
        out[key] = res = splits(args, cfg, device, say, names, comp)
        base = res["1x1"]["losses"]
        for split in names[1:]:
            got = res[split]["losses"]
            gap = max(abs(a - b) for a, b in zip(got, base))
            res[split]["loss_gap"] = gap
            say(f"tp[{split} {comp}]: losses within {gap:.3g} of 1x1's; "
                f"step ms {res[split]['wall_ms']} against 1x1's "
                f"{res['1x1']['wall_ms']}")
            if dist.get_rank() == 0 and gap > TP_LOSS_TOL:
                raise SystemExit(f"tp[{split} {comp}]: losses {got} "
                                 f"against 1x1's {base}")
    out["serve"] = serve_steps(args, cfg, device, say)
    return out


def serve_steps(args, cfg, device, say):
    """The serve steps on 2x2 (fsdp, tp_only) against one card's."""
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed.sharding import gather, shard
    from repro_torch.launch.mesh import make_meshspec
    from repro_torch.models import lm
    from repro_torch.ps.stepfn import (StepKnobs, _model_only,
                                       build_decode_step, build_prefill_step,
                                       cache_specs, serve_param_specs)
    ms = make_meshspec(2, 2)
    P, steps, max_seq = ((TP_P, TP_STEPS, TP_MAX) if not args.reduced
                         else (16, 4, 32))
    B = 8
    whole_p = lm.init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device=device)

    def run(prefill, decode, params, m=None, knobs=None):
        """Greedy tokens (B, steps) and the decode steps' ms."""
        logits, pc = prefill(params, {"tokens": tokens})
        shapes = lm.init_cache_shapes(cfg, B, max_seq)
        cache = {}
        specs = None if m is None else cache_specs(shapes, m)
        pspecs = None if m is None else cache_specs(
            lm.init_cache_shapes(cfg, B, P), m)
        for k, v in pc.items():
            if m is not None:
                v = gather(v, _model_only(pspecs[k], m), m)
            dense = torch.zeros(v.shape[:2] + (max_seq,) + v.shape[3:],
                                dtype=torch.bfloat16, device=device)
            dense[:, :, :P] = v
            if m is not None:
                dense = shard(dense, _model_only(specs[k], m), m)
            cache[k] = dense.contiguous()
        del pc
        out, walls = [], []
        for i in range(steps):
            nt = logits[:, -1].argmax(-1, keepdim=True)
            if m is not None:             # every rank's rows, whole
                nt = gather(nt, (m.data_axes[0], None), m)
            out.append(nt)
            pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
            with Clock(device) as c:
                logits, _ = decode(params, cache, nt, pos)
            walls.append(round(c.s * 1e3, 2))
        return torch.cat(out, 1).tolist(), walls

    ref, ref_ms = run(lambda p, b: lm.prefill(p, b["tokens"], cfg),
                      lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
                      whole_p)
    res = {"single_ms": ref_ms}
    for mode in ("fsdp", "tp_only"):
        knobs = StepKnobs(serve_params=mode)
        specs = serve_param_specs(cfg, ms, knobs)
        params = tree_map(lambda x, sp: shard(x, sp, ms).clone(), whole_p,
                          specs)
        got, ms_list = run(build_prefill_step(cfg, ms, knobs),
                           build_decode_step(cfg, ms, knobs,
                                             max_seq=max_seq), params, ms)
        same = sum(a == b for a, b in zip(ref, got))
        ties = all(tie_aware(cfg, whole_p, tokens[i].tolist(), ref[i],
                             got[i]) for i in range(B))
        res[mode] = {"same": same, "tie_aware": ties, "step_ms": ms_list}
        say(f"tp serve[2x2 {mode}]: {same}/{B} requests one card's tokens "
            f"over {steps} greedy steps, the rest "
            f"{'tie-aware' if ties else 'NOT tie-aware'}; decode ms "
            f"{ms_list[1:]} against one card's {ref_ms[1:]}")
        if dist.get_rank() == 0 and not ties:
            raise SystemExit(f"tp serve[{mode}]: a token no tie explains")
        del params
    return res


def _events_ms(device, fn, iters=20):
    """Median CUDA-event ms of ``fn``, every rank's host at a barrier and
    its device idle before each call."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return round(sorted(times)[len(times) // 2], 4)


def top_kernels(device, fn, iters=5, n=6) -> list:
    """The ``n`` kernels with the most device time over ``iters`` calls of
    ``fn`` (torch.profiler, this rank): (name, ms a call)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            torch.cuda.synchronize()
            dist.barrier()
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:60], e.device_time_total / 1e3 / iters)
            for e in prof.key_averages() if e.device_time_total > 0]
    return [(k, round(v, 4)) for k, v in
            sorted(rows, key=lambda r: -r[1])[:n]]


def probe(cfg, device, say, ms, whole_p, setting, max_seq):
    """The decode step's replay with the hosts aligned, and its logits
    all-gather alone."""
    from repro_torch.distributed.sharding import gather
    from repro_torch.serving import ServingEngine
    out = {}
    for name, m in (("single", None), ("2x2 whole", ms)):
        eng = ServingEngine(whole_p, cfg, setting, max_seq=max_seq,
                            device=device, ms=m)
        n = eng.n_slots
        tok = torch.ones((n, 1), dtype=torch.long, device=device)
        pos = torch.full((n,), 320, dtype=torch.int32, device=device)
        step = eng._decode_exec(eng._ctx_cols(320))

        def run():
            step(eng.params, eng.pool.decode_cache(), tok, pos)

        out[name] = _events_ms(device, run)
        out[name + " kernels"] = top_kernels(device, run)
        del eng, step
    rows = torch.zeros((4, 1, cfg.vocab_size), dtype=torch.bfloat16,
                       device=device)
    spec = ("data", None, None)
    out["all_gather eager"] = _events_ms(device,
                                         lambda: gather(rows, spec, ms))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather(rows, spec, ms)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
        gather(rows, spec, ms)
    out["all_gather graph"] = _events_ms(device, g.replay)
    say(f"engine[probe]: one decode step's replay, hosts aligned: single "
        f"{out['single']} ms, 2x2 whole {out['2x2 whole']} ms; the logits' "
        f"all-gather ({rows.numel() * 2} bytes a rank) eager "
        f"{out['all_gather eager']} ms, captured {out['all_gather graph']} "
        f"ms (CUDA events, rank 0)")
    for name in ("single", "2x2 whole"):
        say(f"engine[probe {name}]: device ms a replay by kernel (profiler, "
            f"rank 0): {out[name + ' kernels']}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ckpt-layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--only", choices=("train", "engine", "tp"),
                    default=None)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="--only tp: the train steps of 4x1, 2x2 and 1x4 "
                         "alone (no 1x1, int8 or serve steps), to time "
                         "two trees in one call")
    args = ap.parse_args()
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_distributed
    rank, size = init_distributed(args.device,
                                  timeout=datetime.timedelta(seconds=240))
    device = torch.device("cuda" if args.device == "cuda" else args.device)
    if args.probe and device.type != "cuda":
        raise SystemExit("--probe times on the card")
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
        line = {}
        if args.only in (None, "train"):
            line["splits"] = splits(args, cfg, device, say)
            line["type_ib"] = relocations(args, cfg, device, say)
        if args.only in (None, "engine"):
            line["engine"] = engines(args, cfg, device, say)
        if args.only in (None, "tp"):
            line["tp"] = tp_arm(args, cfg, device, say)
        line["seconds"] = round(time.perf_counter() - t0, 1)
        say(json.dumps(line))
        say("OK")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    main()
