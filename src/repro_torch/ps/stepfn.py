"""The training step of one system setting (the JAX package's
``ps/stepfn.py`` ``StepKnobs``, ``train_state_shapes`` and
``build_train_step``).

A setting's Type II knobs are baked into the step closure: microbatches
and their accumulator dtype, layer recomputation, gradient compression,
delayed-gradient staleness, the attention and cross-entropy chunking.

The step updates its state **in place**: parameters, optimizer moments,
the staleness queue and ``step`` are written where they lie, and the same
dict is returned.  At full width (4.31 B parameters: 8.6 GB of bf16
weights, 34.5 GB of f32 Adam moments) a step that returned a new state,
as JAX's functional one does, would need the state twice.

The mesh side (``state_specs``, ``batch_specs``, ``cache_specs``, the
``jit_*`` wrappers) and the serve steps come with the mesh slice and are
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.optim import make_optimizer, opt_state_shapes
from repro_torch.ps.compression import compress_grads

ACC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclass(frozen=True)
class StepKnobs:
    """The system setting X of a training step (paper §III): the Type II
    knobs the port's step reads.  The JAX package's mesh and scan knobs
    (``scan_unroll``, ``q_chunk``, ``ssm_chunk``, ``attn_skip_masked``,
    ``serve_params``, ``seq_shard``, ``donate``) have no meaning in an
    eager single-device step and are not carried."""
    microbatches: int = 1
    remat: str = "none"              # none | dots | full
    compression: str = "none"        # none | bf16 | int8
    staleness: int = 0               # delayed-gradient depth (ASP emulation)
    k_chunk: int = 1024
    ce_chunk: int = 0
    acc_dtype: str = "f32"           # microbatch grad-accumulator precision

    def model_knobs(self) -> ModelKnobs:
        return ModelKnobs(k_chunk=self.k_chunk, remat=self.remat,
                          ce_chunk=self.ce_chunk)


def train_state_shapes(cfg: ModelConfig, tc: TrainConfig,
                       opt_dtype=torch.float32,
                       knobs: StepKnobs = StepKnobs()) -> dict:
    """The train state's (shape, dtype) leaves, without allocating."""
    pdt = lm._pdt(cfg)
    ps = tree_map(lambda s: (tuple(s), pdt), lm.param_shapes(cfg))
    state = {"params": ps,
             "opt": opt_state_shapes(lm.param_shapes(cfg), tc, opt_dtype),
             "step": ((), torch.int32)}
    if knobs.staleness > 0:
        state["grad_queue"] = tree_map(
            lambda s: ((knobs.staleness,) + s[0], torch.bfloat16), ps)
    return state


def _grads(params, batch, cfg, mk):
    """(loss, aux, grads) of ``lm.loss_fn`` at ``params``: autograd over
    detached leaves that share the parameters' memory.

    A stacked layer weight (L, ...) enters as L leaves, one a layer (the
    forward indexes ``v[i]`` alike), and its gradient is stacked once at
    the end: with the stacked tensor as one leaf, every layer's slice
    would give back a zero-filled gradient of the whole stack, summed L
    times (at full width 30 x 8.6 GB of fills and adds a step).  A leaf
    the loss does not use (the vlm's ``frontend/proj`` on a text batch,
    the encoder's ``embed/tokens`` on frames) gets a zero gradient, as
    ``jax.grad`` gives it."""
    paths, pl = flatten(params)
    stacked = [p.startswith("layers/") for p in paths]
    with torch.enable_grad():
        ls = [[t.detach().requires_grad_() for t in p.unbind(0)] if st
              else p.detach().requires_grad_()
              for p, st in zip(pl, stacked)]
        loss, aux = lm.loss_fn(unflatten(paths, ls), batch, cfg, mk)
        flat = [t for x in ls for t in (x if isinstance(x, list) else [x])]
        gl = [torch.zeros_like(t) if g is None else g for t, g in zip(
            flat, torch.autograd.grad(loss, flat, allow_unused=True))]
    del flat, ls
    grads, i = [], 0
    for p, st in zip(pl, stacked):
        n = p.shape[0] if st else 1
        part, gl[i:i + n] = gl[i:i + n], [None] * n
        grads.append(torch.stack(part) if st else part[0])
        del part
        i += n
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        unflatten(paths, grads)


def build_train_step(cfg: ModelConfig, tc: TrainConfig,
                     knobs: StepKnobs = StepKnobs()):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place; ``metrics`` holds 0-dim f32 tensors
    ``loss`` and ``ce`` on the device (nothing is read back)."""
    mk = knobs.model_knobs()
    _, opt_update = make_optimizer(tc)
    n = knobs.microbatches

    def compute_grads(params, batch):
        if n <= 1:
            return _grads(params, batch, cfg, mk)
        adt = ACC_DTYPES[knobs.acc_dtype]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                             device=p.device), params)
        labels = batch["labels"]           # every batch kind has labels
        tot = torch.zeros((), dtype=torch.float32, device=labels.device)
        mb = labels.shape[0] // n
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, g = _grads(params, part, cfg, mk)
            for a, gg in zip(leaves(acc), leaves(g)):
                a.add_(gg.to(adt))
            del g
            tot = tot + loss
        for a in leaves(acc):
            a.div_(n)
        return tot / n, {"ce": tot / n}, acc

    @torch.no_grad()
    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = compute_grads(params, batch)
        grads = compress_grads(
            grads, knobs.compression,
            state["step"] if knobs.compression == "int8" else 0)
        if knobs.staleness > 0:
            # delayed-gradient ASP: apply the gradient of `staleness` steps
            # ago and push the fresh one (bf16) into the queue; before the
            # queue is warm the fresh gradient applies
            # (leaf by leaf, in place: the applied gradient replaces the
            # fresh one in its tensor once the queue has taken it)
            warm = state["step"] >= knobs.staleness
            for g, q in zip(leaves(grads), leaves(state["grad_queue"])):
                apply = torch.where(warm, q[0].to(g.dtype), g)
                for j in range(knobs.staleness - 1):
                    q[j].copy_(q[j + 1])
                q[-1].copy_(g)
                g.copy_(apply)
                del apply
        opt_update(params, grads, state["opt"])
        state["step"] += 1
        return state, {"loss": loss.float(), "ce": aux["ce"].float()}

    return train_step
