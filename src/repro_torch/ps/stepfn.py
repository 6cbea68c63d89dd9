"""The training and serving steps of one system setting (the JAX
package's ``ps/stepfn.py``: ``StepKnobs``, ``train_state_shapes``,
``build_train_step`` and ``jit_train_step``; ``build_prefill_step``,
``build_decode_step`` and ``jit_serve_step``).

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
tensor, so the mesh step at 1x1 is the single-device step.

The serve steps (prefill, and decode over the dense per-slot cache of
``lm.init_cache``) under a mesh: the parameters placed by ``param_specs``
(``serve_params="fsdp"``) or over ``model`` only (``"tp_only"``: the pull
then gathers over ``model`` alone), the cache by ``cache_specs`` (batch
over the data axes, the sequence (attention) or the channels (ssm) over
``model``).  A step pulls the parameters, computes on the rank's shard of
the batch, and for the cache rows it holds over ``model`` gathers each
layer's cache whole before the layer and keeps its own shard of what the
layer wrote (``_GatheredLayers``).  It returns the rank's rows of the
logits and its shards of the cache.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
from repro_torch.distributed.sharding import (MeshSpec, fit_act_spec, gather,
                                              is_whole, param_specs, shape_of,
                                              shard)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.optim import make_optimizer, opt_state_shapes
from repro_torch.ps.compression import compress_grads

ACC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the JAX package's StepKnobs fields the port's steps do not carry
NOT_CARRIED = ("scan_unroll", "q_chunk", "ssm_chunk", "attn_skip_masked",
               "seq_shard", "donate")


@dataclass(frozen=True)
class StepKnobs:
    """The system setting X of a step (paper §III): the Type II knobs the
    port's steps read, and the serve steps' parameter placement.  The JAX
    package's compiler and scan knobs (``scan_unroll``, ``q_chunk``,
    ``ssm_chunk``, ``attn_skip_masked``, ``seq_shard``, ``donate``) have no
    meaning in the port's eager steps and are not carried
    (``NOT_CARRIED``)."""
    microbatches: int = 1
    remat: str = "none"              # none | dots | full
    compression: str = "none"        # none | bf16 | int8
    staleness: int = 0               # delayed-gradient depth (ASP emulation)
    k_chunk: int = 1024
    ce_chunk: int = 0
    acc_dtype: str = "f32"           # microbatch grad-accumulator precision
    serve_params: str = "fsdp"       # fsdp | tp_only (serve placement)

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


def _pull(params, pspecs, ms):
    """The PS pull: each parameter all-gathered whole over the axes its
    spec names (the parameters themselves off a mesh)."""
    if ms is None:
        return params
    return tree_map(lambda p, s: gather(p, s, ms), params, pspecs)


def _local_batch(batch, ms):
    """This rank's part of a (micro)batch under ``batch_specs`` and the
    MeshSpec the forward sees, whose ``batch_axes`` say how the part lies
    over the data axes."""
    if ms is None:
        return batch, None
    specs = batch_specs(batch, ms)
    part = tree_map(lambda x, s: shard(x, s, ms), batch, specs)
    # every training batch has labels; a serving batch tokens or frames
    key = next(k for k in ("labels", "tokens", "frontend") if k in specs)
    b = specs[key][0]
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
        params = _pull(state["params"], None if ms is None
                       else specs["params"], ms)
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


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def serve_param_specs(cfg: ModelConfig, ms: MeshSpec,
                      knobs: StepKnobs = StepKnobs()):
    """Specs of the serving parameters: ``param_specs`` on ``ms``
    (``"fsdp"``), or on ``ms`` with no data axes (``"tp_only"``: sharded
    over ``model`` only, whole along the data axes)."""
    if knobs.serve_params not in ("fsdp", "tp_only"):
        raise ValueError(f"serve_params {knobs.serve_params!r}: fsdp | "
                         f"tp_only")
    pms = (dataclasses.replace(ms, data_axes=())
           if knobs.serve_params == "tp_only" else ms)
    return param_specs(lm.param_shapes(cfg), pms)


def _model_only(spec: tuple, ms: MeshSpec) -> tuple:
    """The entries of ``spec`` over ``model`` (the rest None): the part of
    a cache leaf's placement that the rank's batch shard does not already
    hold."""
    return tuple(e if e == ms.model_axis else None for e in spec)


class _GatheredLayers:
    """The layer views of a stacked cache leaf whose rank holds a shard
    over ``model``: ``[i]`` all-gathers layer i whole (the step writes its
    new rows there in place), after writing the previously opened layer's
    shard back into the rank's cache; ``close()`` writes the last one.
    ``shape`` is the whole leaf's, as the forward reads it."""

    def __init__(self, local, spec: tuple, ms: MeshSpec):
        self.local, self.ms = local, ms
        self.spec = spec[1:]                # a layer view's
        self.shape = (local.shape[0],) + tuple(
            n * ms.size_of(e) for n, e in zip(local.shape[1:], self.spec))
        self.open = None

    def __getitem__(self, i: int):
        self.close()
        whole = gather(self.local[i], self.spec, self.ms)
        self.open = (i, whole)
        return whole

    def close(self):
        if self.open is not None:
            i, whole = self.open
            self.local[i].copy_(shard(whole, self.spec, self.ms))
            self.open = None


def build_prefill_step(cfg: ModelConfig, ms: MeshSpec = None,
                       knobs: StepKnobs = StepKnobs()):
    """Returns ``prefill_step(params, batch) -> (logits, cache)``: the
    last position's logits and the prefill cache, ``lm.prefill`` of
    ``batch["tokens"]`` (and ``batch["frontend"]``, the vlm's patches or
    the encoder's frames).  Under a mesh every rank calls it with its
    parameter shards (``serve_param_specs``) and the whole batch; it
    computes on its data shard and returns its logits rows and its shards
    of the cache (``cache_specs`` of the whole cache)."""
    mk = knobs.model_knobs()
    pspecs = None if ms is None else serve_param_specs(cfg, ms, knobs)

    @torch.no_grad()
    def prefill_step(params, batch):
        p = _pull(params, pspecs, ms)
        part, act = _local_batch(batch, ms)
        logits, cache = lm.prefill(p, part.get("tokens"), cfg, mk,
                                   frontend=part.get("frontend"), ms=act)
        if ms is not None:
            # the batch dims are the rank's already; keep its model shard
            lead = batch.get("tokens", batch.get("frontend"))
            whole = {k: (v.shape[0], lead.shape[0]) + tuple(v.shape[2:])
                     for k, v in cache.items()}
            specs = cache_specs(whole, ms)
            cache = {k: shard(v, _model_only(specs[k], ms), ms).contiguous()
                     for k, v in cache.items()}
        return logits, cache

    return prefill_step


def build_decode_step(cfg: ModelConfig, ms: MeshSpec = None,
                      knobs: StepKnobs = StepKnobs(), max_seq: int = None):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits,
    cache)``: ``lm.decode_step`` over the dense per-slot cache, written in
    place.  Under a mesh every rank calls it with its parameter shards,
    its shards of the whole cache ``lm.init_cache_shapes(cfg, B,
    max_seq)`` under ``cache_specs`` (``max_seq``: where a cache leaf has a
    sequence axis), and the whole tokens (B, S) and pos (B,); it computes
    on its data shard, gathering each layer's cache over ``model``
    (``_GatheredLayers``), and returns its logits rows."""
    mk = knobs.model_knobs()
    pspecs = None if ms is None else serve_param_specs(cfg, ms, knobs)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        p = _pull(params, pspecs, ms)
        if ms is None:
            return lm.decode_step(p, cache, tokens, pos, cfg, mk)
        part, act = _local_batch({"tokens": tokens, "pos": pos}, ms)
        specs = cache_specs(lm.init_cache_shapes(cfg, tokens.shape[0],
                                                 max_seq), ms)
        views = {}
        for k, v in cache.items():
            spec = _model_only(specs[k], ms)
            views[k] = (_GatheredLayers(v, spec, ms)
                        if not is_whole(spec, ms) else v)
        logits, _ = lm.decode_step(p, views, part["tokens"], part["pos"],
                                   cfg, mk, ms=act)
        for v in views.values():
            if isinstance(v, _GatheredLayers):
                v.close()
        return logits, cache

    return serve_step


def jit_serve_step(cfg: ModelConfig, shape: ShapeConfig, ms: MeshSpec,
                   knobs: StepKnobs = StepKnobs()):
    """The serve step of a prefill or decode cell with its shapes, as the
    JAX package's: (prefill step, parameter shapes), or (decode step,
    (parameter shapes, cache shapes)).  ``knobs.serve_params ==
    "tp_only"`` keeps the parameters sharded on ``model`` only, so decode
    gathers over ``model`` alone instead of all-gathering the FSDP shards
    every step.  (The port's steps are eager: nothing is compiled.)"""
    pshapes = lm.param_shapes(cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, ms, knobs), pshapes
    if shape.kind != "decode":
        raise ValueError(f"jit_serve_step: kind {shape.kind!r} is not a "
                         f"serve step")
    cshapes = lm.init_cache_shapes(cfg, shape.global_batch, shape.seq_len)
    return (build_decode_step(cfg, ms, knobs, max_seq=shape.seq_len),
            (pshapes, cshapes))
