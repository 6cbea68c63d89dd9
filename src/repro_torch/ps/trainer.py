"""Self-tuning training driver (the JAX package's ``ps/trainer.py``).

``SelfTuningLoop`` is the system-agnostic glue of paper Fig. 3: it runs the
instrumented job, streams per-iteration metrics (execution time, loss) into
the TuningManager, and executes the ReconfigPlans the manager emits:

  Type II       — swap the step closure of the new setting (built, or found
                  in the bounded step cache, inside the measured
                  reconfiguration window);
  state surgery — resize the staleness queue when the ASP knob changes.

The port's step is eager PyTorch, so "compiling" a setting means building
its closure: the first step of a new setting then pays cuBLAS's and the
allocator's warm-up.  The step is not captured as a CUDA graph: a captured
training step would keep a private pool of full-width activations (several
GB) for every setting the cache holds.

  Type I-b  — relocate the state onto another mesh (``LMJob``'s adapter:
              ODMR or the checkpoint + restore baseline).

Multi-controller (one process a device, a process group up): rank 0
alone measures, feeds the tuner and decides; it broadcasts whether to go
on and every plan, so every rank applies the same plan at the same
iteration (the ranks' step times differ, and a tuner a rank would
diverge).  Every rank calls the checkpoint manager (a sharded save
gathers on every rank; the mesh's first rank writes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.knobs import setting_key
from repro_torch.core.lru import LRUCache
from repro_torch.core.reconfig import ReconfigPlan
from repro_torch.core.tree import leaves
from repro_torch.device import synchronize
from repro_torch.launch.mesh import world
from repro_torch.obs.trace import NOP_TRACER


@dataclass
class LoopResult:
    iterations: int
    wall_time_s: float
    final_loss: float
    converged: bool
    reconfig_total_s: float
    history: list


def _device_of(state) -> torch.device:
    return leaves(state["params"])[0].device


class SelfTuningLoop:
    def __init__(self, tuner, step_builder: Callable[[dict], Callable],
                 state_adapter: Callable | None = None,
                 checkpoint_manager=None, step_cache_size: int = 8,
                 tracer=None):
        self.tuner = tuner
        self.step_builder = step_builder
        self.state_adapter = state_adapter or (lambda state, plan: state)
        self.ckpt = checkpoint_manager
        # bounded: the tuner's exploration history would otherwise keep one
        # step per visited setting forever
        self._steps = LRUCache(step_cache_size)
        # one tracer across loop + tuner + step cache, so a run's
        # wall-clock decomposes into step / rebuild / tuner deliberation
        # (repro_torch.obs.report.time_attribution)
        self.tracer = tracer or NOP_TRACER
        self._steps.tracer = self.tracer
        if tracer is not None:
            tuner.tracer = tracer

    def _get_step(self, setting: dict):
        return self._steps.get_or_create(
            setting_key(setting), lambda: self.step_builder(setting))

    def run(self, state, batch_iter, max_iters: int = 10_000,
            verbose: bool = False) -> tuple[LoopResult, object]:
        tuner = self.tuner
        rank, size = world()
        lead = rank == 0
        verbose = verbose and lead

        def from_lead(obj):
            if size == 1:
                return obj
            import torch.distributed as dist
            box = [obj]
            dist.broadcast_object_list(box, src=0)
            return box[0]

        dev = _device_of(state)
        batch = next(batch_iter)
        step = self._get_step(tuner.current)
        t_start = time.perf_counter()
        reconfig_total = 0.0
        it = 0
        loss = float("nan")
        while from_lead(lead and it < max_iters and not tuner.converged):
            t0 = time.perf_counter()
            with self.tracer.span("train.step", it=it):
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])      # waits for the step
            dt = time.perf_counter() - t0
            it += 1
            if lead:
                tuner.record_iteration(loss, dt)
            if self.ckpt is not None:
                self.ckpt.maybe_save(state, it, {"loss": loss})
            batch = next(batch_iter)

            plan = from_lead(tuner.maybe_advance() if lead else None)
            if plan is not None:
                with self.tracer.span("reconfig.apply",
                                      kinds=",".join(plan.kinds)):
                    r0 = time.perf_counter()
                    # plan.new, not tuner.current: the tuner stays on the
                    # incumbent until record_reconfig commits the switch
                    state = self.state_adapter(state, plan)
                    step = self._get_step(plan.new)
                    synchronize(dev)
                    rcost = time.perf_counter() - r0
                reconfig_total += rcost
                if lead:
                    tuner.record_reconfig(plan, rcost)
                if verbose:
                    print(f"[reconfig@{it}] {plan.kinds} -> {tuner.current} "
                          f"({rcost:.3f}s)", flush=True)
            if verbose and it % 50 == 0:
                print(f"[{it}] loss={loss:.4f} setting={tuner.current}",
                      flush=True)
        wall = time.perf_counter() - t_start
        # the other ranks' tuners saw nothing: they report their own loss
        # and the lead's verdict
        return LoopResult(
            iterations=it, wall_time_s=wall,
            final_loss=tuner.repo.latest_loss if lead else loss,
            converged=from_lead(tuner.converged if lead else None),
            reconfig_total_s=reconfig_total,
            history=tuner.history if lead else [],
        ), state


def make_staleness_adapter(queue_dtype=torch.bfloat16):
    """Grad-queue surgery when the ASP ``staleness`` knob changes (a Type
    II change that touches state shape); the knob's value is the queue's
    depth.  ``queue_dtype`` must match what the job's step pushes (bf16
    for the LM path).  The newest ``min(old, new)`` entries are kept;
    new slots are zeros.  The queue is rebuilt leaf by leaf, each old leaf
    dropped from the old queue once its successor holds what it keeps, so
    a full-width resize holds one leaf twice, not the queue: the state
    given is spent (its queue loses its leaves), use the one returned."""

    @torch.no_grad()
    def adapter(state, plan: ReconfigPlan):
        old_s = plan.old.get("staleness", 0)
        new_s = plan.new.get("staleness", 0)
        if old_s == new_s:
            return state
        state = dict(state)
        old_q = state.pop("grad_queue", None)
        if new_s == 0:
            return state
        keep = min(old_s, new_s) if old_q is not None else 0

        def resize(params, queue):
            out = {}
            for k, p in params.items():
                if isinstance(p, dict):
                    out[k] = resize(p, queue[k] if queue else None)
                    continue
                z = torch.zeros((new_s,) + tuple(p.shape),
                                dtype=queue_dtype or p.dtype, device=p.device)
                if keep:
                    z[-keep:] = queue[k][-keep:].to(z.dtype)
                    queue[k] = None              # the old leaf can go
                out[k] = z
            return out

        state["grad_queue"] = resize(state["params"], old_q)
        return state

    return adapter
