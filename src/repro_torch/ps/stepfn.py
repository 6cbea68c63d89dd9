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

Under a mesh (``ms``) the step follows the PS mapping as explicit
collectives, one process a device, each rank holding only its shards of
the state (``state_specs``):

1. **pull**: all-gather each parameter over the axes its spec names;
2. **compute**: forward and backward on the rank's shard of the batch
   (``batch_specs``: the batch over the data axes; the step takes the
   whole batch and keeps its part), the ranks along ``model`` on the same
   shard;
3. **push**: the gradients summed over the data axes and divided by their
   size (each rank's loss is the mean over its shard), then compressed
   whole, every rank drawing int8's uniforms from the same generator, and
   each rank keeps the slice its shards own;
4. **update**: the optimizer in place on the local shards.

At one device every collective is skipped and every shard is the whole
tensor, so the mesh step at 1x1 is the single-device step.  The serve
steps (``jit_serve_step``, ``build_prefill_step``, ``build_decode_step``)
are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
from repro_torch.distributed.sharding import (MeshSpec, fit_act_spec, gather,
                                              param_specs, shape_of, shard)
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


def state_specs(state_shapes, ms: MeshSpec):
    """Specs of a train state: opt m/v/mu and the queue mirror the params
    (the queue with a leading None), ``count`` and ``step`` replicated."""
    pspecs = param_specs(state_shapes["params"], ms)
    out = {"params": pspecs, "step": ()}
    out["opt"] = {k: (() if k == "count" else pspecs)
                  for k in state_shapes["opt"]}
    if "grad_queue" in state_shapes:
        out["grad_queue"] = tree_map(lambda spec: (None,) + spec, pspecs)
    return out


def batch_specs(batch_shapes, ms: MeshSpec):
    """The batch over the data axes (dim 0), where it divides."""
    def spec(s):
        shape = shape_of(s)
        if len(shape) == 0:
            return ()
        return fit_act_spec(shape, ("D",) + (None,) * (len(shape) - 1), ms)
    return tree_map(spec, batch_shapes)


def cache_specs(cache_shapes, ms: MeshSpec):
    """Decode caches: batch over data, seq (attn) / channels (ssm) on
    model.  A pure function of the shapes (tensors, shapes or JAX's
    ``ShapeDtypeStruct``)."""
    def spec(name, s):
        shape = shape_of(s)
        if name in ("k", "v", "shared_k", "shared_v"):
            # (L|A, B, Smax, K, hd): batch->data, seq->model
            return fit_act_spec(shape, (None, "D", "M", None, None), ms)
        if name == "conv":
            return fit_act_spec(shape, (None, "D", "M", None), ms)
        if name == "h":
            syms = (None, "D", "M") + (None,) * (len(shape) - 3)
            return fit_act_spec(shape, syms, ms)
        return (None,) * len(shape)
    paths, lv = flatten(cache_shapes)
    return unflatten(paths, [spec(p.rsplit("/", 1)[-1], x)
                             for p, x in zip(paths, lv)])


def _grads(params, batch, cfg, mk, ms=None):
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
        loss, aux = lm.loss_fn(unflatten(paths, ls), batch, cfg, mk, ms=ms)
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


def _local_batch(batch, ms):
    """This rank's part of a (micro)batch under ``batch_specs`` and the
    MeshSpec the forward sees, whose ``batch_axes`` say how the part lies
    over the data axes."""
    if ms is None:
        return batch, None
    specs = batch_specs(batch, ms)
    part = tree_map(lambda x, s: shard(x, s, ms), batch, specs)
    b = specs["labels"][0]           # every batch kind has labels
    axes = () if b is None else ((b,) if isinstance(b, str) else tuple(b))
    return part, dataclasses.replace(ms, batch_axes=axes)


def build_train_step(cfg: ModelConfig, tc: TrainConfig,
                     knobs: StepKnobs = StepKnobs(), ms: MeshSpec = None,
                     out_ms: MeshSpec = None, out_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place; ``metrics`` holds 0-dim f32 tensors
    ``loss`` and ``ce`` on the device (nothing is read back).

    ``ms``: the mesh the state is placed on (``state_specs``); the step
    takes the whole batch and every rank of the mesh calls it.  ``out_ms``
    / ``out_specs``: write p, m, v and the queue under another placement
    (ODMR's relocation inside a step, ``odmr.transition_step``; the
    ``out_state_specs`` hook of ``jit_train_step``): the new shards are
    cut from the pulled parameters and the whole gradient, updated there,
    and the state returned is a new dict (the one given is spent)."""
    mk = knobs.model_knobs()
    _, opt_update = make_optimizer(tc)
    n = knobs.microbatches
    specs = ospecs = None
    if ms is not None:
        shapes = train_state_shapes(cfg, tc, knobs=knobs)
        specs = state_specs(shapes, ms)
        out_ms = out_ms or ms
        ospecs = out_specs or (specs if out_ms is ms
                               else state_specs(shapes, out_ms))
    relocating = ms is not None and (out_ms is not ms or ospecs is not specs)

    def pull(params):
        if ms is None:
            return params
        return tree_map(lambda p, s: gather(p, s, ms), params,
                        specs["params"])

    def push(tensors):
        """Each tensor (whole gradients, the losses) averaged over the data
        axes, in place."""
        if ms is None or ms.data_size == 1:
            return
        import torch.distributed as dist
        for t in tensors:
            dist.all_reduce(t, group=ms.data_group)
            t.div_(ms.data_size)

    def compute_grads(params, batch):
        if n <= 1:
            part, act = _local_batch(batch, ms)
            return _grads(params, part, cfg, mk, act)
        adt = ACC_DTYPES[knobs.acc_dtype]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                             device=p.device), params)
        labels = batch["labels"]           # every batch kind has labels
        tot = torch.zeros((), dtype=torch.float32, device=labels.device)
        mb = labels.shape[0] // n
        for i in range(n):
            part, act = _local_batch(
                {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, ms)
            loss, _, g = _grads(params, part, cfg, mk, act)
            for a, gg in zip(leaves(acc), leaves(g)):
                a.add_(gg.to(adt))
            del g
            tot = tot + loss
        for a in leaves(acc):
            a.div_(n)
        return tot / n, {"ce": tot / n}, acc

    def own(tree, key):
        """The rank's shards of a whole tree under the output placement,
        each its own contiguous tensor."""
        if ms is None:
            return tree
        return tree_map(lambda x, s: shard(x, s, out_ms).contiguous(), tree,
                        ospecs[key])

    def moved(tree, old, new):
        return tree_map(lambda x, s, s2: shard(gather(x, s, ms), s2,
                                               out_ms).contiguous(),
                        tree, old, new)

    def relocate(state, params):
        """p, m, v and the queue at their new home: p from the pulled
        whole parameters, the rest gathered under the old placement, one
        leaf at a time."""
        new = {"params": own(params, "params"), "step": state["step"],
               "opt": {k: (v if k == "count" else moved(
                   v, specs["params"], ospecs["params"]))
                   for k, v in state["opt"].items()}}
        if "grad_queue" in state:
            new["grad_queue"] = moved(state["grad_queue"],
                                      specs["grad_queue"],
                                      ospecs["grad_queue"])
        return new

    @torch.no_grad()
    def train_step(state, batch):
        params = pull(state["params"])
        loss, aux, grads = compute_grads(params, batch)
        push(leaves(grads) + [loss, aux["ce"]])
        grads = compress_grads(
            grads, knobs.compression,
            state["step"] if knobs.compression == "int8" else 0)
        if relocating:
            state = relocate(state, params)
        del params
        grads = own(grads, "params")
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
        opt_update(state["params"], grads, state["opt"])
        state["step"] += 1
        return state, {"loss": loss.float(), "ce": aux["ce"].float()}

    return train_step


def jit_train_step(cfg: ModelConfig, tc: TrainConfig, ms: MeshSpec,
                   knobs: StepKnobs = StepKnobs(), opt_dtype=torch.float32,
                   out_state_specs=None):
    """The mesh step with its state shapes and specs: (step, shapes,
    specs).  ``out_state_specs`` overrides the output placement on the
    same mesh — the ODMR hook: pass the *new* layout to relocate the state
    during a normal step."""
    step = build_train_step(cfg, tc, knobs, ms=ms, out_specs=out_state_specs)
    sshapes = train_state_shapes(cfg, tc, opt_dtype, knobs)
    return step, sshapes, state_specs(sshapes, ms)
