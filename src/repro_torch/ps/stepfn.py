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
the state (``state_specs``), and computes partitioned over ``model`` as
the reference's GSPMD step does (``sharding.tp_plan``):

1. **pull, layer by layer**: inside the layer loop each layer's shards
   are all-gathered at their use (``collectives.gather_params``) and freed
   after it: over the data axes only where the attention families' layer
   computes on its ``model`` shard (column-parallel wq, wk, wv, wi, wg and
   the vocabulary; row-parallel wo), over every axis where the compute is
   whole on every rank (the ssm and hybrid layers, attention whose heads
   do not divide).  Under ``keep_shards`` autograd keeps the shard, not
   the gathered tensor, and the backward gathers again, so a rank never
   holds more than its shards and one layer;
2. **compute**: forward and backward on the rank's shard of the batch
   (``batch_specs``: the batch over the data axes; the step takes the
   whole batch and keeps its part), the ranks along ``model`` each on
   their part of every layer (Megatron's f and g, ``to_model`` and
   ``from_model``, at named points of ``lm._attn_layer``);
3. **push**: the pull's backward reduce-scatters each gradient over the
   data axes its spec names (a leaf replicated over a data axis, a norm's
   scale, is all-reduced over it), and every shard is divided by the data
   size (each rank's loss is the mean over its shard); then compressed on
   the shards with the whole leaf's numerics (``compress_grads``: one
   int8 scale a leaf, the shard's slice of the whole leaf's uniforms);
4. **update**: the optimizer in place on the local shards.

At one device every collective is skipped and every shard is the whole
tensor, so the mesh step at 1x1 is the single-device step.

The serve steps (prefill, and decode over the dense per-slot cache of
``lm.init_cache``) under a mesh: the parameters placed by ``param_specs``
(``serve_params="fsdp"``) or over ``model`` only (``"tp_only"``: the pull
then gathers over ``model`` alone, and only what the plan computes whole:
nothing where the query and kv heads divide ``model``), the cache by
``cache_specs`` (batch over the data axes, the sequence (attention) or
the channels (ssm) over ``model``).  A step computes on the rank's shard
of the batch, layer by layer as the train step does, and for the cache
rows it holds over ``model`` gathers each layer's cache before the layer
and keeps its own shard of what the layer wrote (``_GatheredLayers``; on
the head path ``_HeadLayers``, the rank's kv heads, the new rows of every
head all-gathered over ``model``).  It returns the rank's rows of the
logits (whole over the vocabulary) and its shards of the cache.

The serving engine's decode step under a mesh (``build_pool_decode_step``)
runs over a state pool (paged blocks, or per-slot recurrent state) that
every rank holds whole, with the whole parameters (``pull``): the slots
split over the data axes, and after the step each rank's logits rows and
the pool rows it wrote are all-gathered and copied into every replica, so
every rank ends the step with the same pool and the same logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (MeshSpec, TPRank, fit_act_spec,
                                              gather, is_whole, param_specs,
                                              shape_of, shard)
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs, paged_rows, slab_rows
from repro_torch.optim import make_optimizer, opt_state_shapes
from repro_torch.ps.compression import compress_grads

ACC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the JAX package's StepKnobs fields the port's steps do not carry
NOT_CARRIED = ("scan_unroll", "q_chunk", "ssm_chunk", "attn_skip_masked",
               "seq_shard", "donate")


@dataclass(frozen=True)
class StepKnobs:
    """The system setting X of a step (paper §III): the Type II knobs the
    port's steps read, and the serve steps' parameter placement
    (``serve_params``: the shards a serve step is given, ``fsdp`` over
    every axis or ``tp_only`` over ``model``; either way each layer is
    pulled at its use).  The JAX package's compiler and scan knobs
    (``scan_unroll``, ``q_chunk``, ``ssm_chunk``, ``attn_skip_masked``,
    ``seq_shard``, ``donate``) have no meaning in the port's eager steps
    and are not carried (``NOT_CARRIED``); the sequence path of the
    attention families runs where the plan says (``tp_plan``), not by
    ``seq_shard``."""
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


def _grads(params, batch, cfg, mk, ms=None, tp=None):
    """(loss, aux, grads) of ``lm.loss_fn`` at ``params``: autograd over
    detached leaves that share the parameters' memory.  With ``tp``,
    ``params`` are the rank's shards, pulled layer by layer in the forward
    (``lm.forward``) and, under ``keep_shards``, again in the backward;
    each gradient comes out of the pull's backward as the rank's shard,
    summed over the data axes its spec names.

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
    with torch.enable_grad(), (col.keep_shards() if tp is not None
                               else contextlib.nullcontext()):
        ls = [[t.detach().requires_grad_() for t in p.unbind(0)] if st
              else p.detach().requires_grad_()
              for p, st in zip(pl, stacked)]
        loss, aux = lm.loss_fn(unflatten(paths, ls), batch, cfg, mk, ms=ms,
                               tp=tp)
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


def pull(params, pspecs, ms):
    """The whole-parameter pull of the engine's pool step: each parameter
    all-gathered whole over the axes its spec names (the parameters
    themselves off a mesh, or with no specs: whole on every rank)."""
    if ms is None or pspecs is None:
        return params
    return tree_map(lambda p, s: gather(p, s, ms), params, pspecs)


def tp_rank(ms: MeshSpec, pspecs) -> TPRank | None:
    """The rank's ``TPRank`` on ``ms`` for parameters placed by ``pspecs``
    (None off a mesh and at one device: the step is the single-device
    step)."""
    if ms is None or ms.n_devices == 1:
        return None
    return TPRank.of(ms, pspecs)


def _unnamed_data_axes(spec: tuple, ms: MeshSpec) -> tuple:
    """The data axes of size > 1 that ``spec`` names on no dimension: the
    leaf is replicated over them."""
    named = {a for e in spec if e is not None for a in _entry_axes(e)}
    return tuple(a for a in ms.data_axes
                 if a not in named and ms.shape[a] > 1)


def _entry_axes(e) -> tuple:
    """The data axes a spec entry names (``()`` for None)."""
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


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
    return part, dataclasses.replace(ms,
                                     batch_axes=_entry_axes(specs[key][0]))


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
    ``out_state_specs`` hook of ``jit_train_step``): p, m, v, the queue
    and the pushed gradient are moved to their new shards one leaf at a
    time, updated there, and the state returned is a new dict (the one
    given is spent)."""
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
    tp = None if ms is None else tp_rank(ms, specs["params"])

    def push(grads, scalars):
        """The gradient shards (each summed over the data axes its spec
        names by the pull's backward) and the losses averaged over the
        data axes, in place: a leaf replicated over a data axis (a norm's
        scale) is all-reduced over it first."""
        if ms is None or ms.data_size == 1:
            return
        import torch.distributed as dist
        for g, spec in zip(leaves(grads), leaves(specs["params"])):
            axes = _unnamed_data_axes(spec, ms)
            if axes:
                dist.all_reduce(g, group=ms.group(axes))
            g.div_(ms.data_size)
        for t in scalars:
            dist.all_reduce(t, group=ms.data_group)
            t.div_(ms.data_size)

    def compute_grads(params, batch):
        if n <= 1:
            part, act = _local_batch(batch, ms)
            return _grads(params, part, cfg, mk, act, tp)
        adt = ACC_DTYPES[knobs.acc_dtype]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                             device=p.device), params)
        labels = batch["labels"]           # every batch kind has labels
        tot = torch.zeros((), dtype=torch.float32, device=labels.device)
        mb = labels.shape[0] // n
        for i in range(n):
            part, act = _local_batch(
                {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, ms)
            loss, _, g = _grads(params, part, cfg, mk, act, tp)
            for a, gg in zip(leaves(acc), leaves(g)):
                a.add_(gg.to(adt))
            del g
            tot = tot + loss
        for a in leaves(acc):
            a.div_(n)
        return tot / n, {"ce": tot / n}, acc

    def moved(tree, old, new):
        return tree_map(lambda x, s, s2: shard(gather(x, s, ms), s2,
                                               out_ms).contiguous(),
                        tree, old, new)

    def relocate(state):
        """p, m, v and the queue at their new home: each gathered under
        the old placement and cut under the new, one leaf at a time."""
        new = {"params": moved(state["params"], specs["params"],
                               ospecs["params"]),
               "step": state["step"],
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
        loss, aux, grads = compute_grads(state["params"], batch)
        push(grads, [loss, aux["ce"]])
        placed = {} if ms is None else {"specs": specs["params"], "ms": ms}
        grads = compress_grads(
            grads, knobs.compression,
            state["step"] if knobs.compression == "int8" else 0, **placed)
        if relocating:
            state = relocate(state)
            grads = moved(grads, specs["params"], ospecs["params"])
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


def _kv_whole(x, cfg: ModelConfig, plan, tp: TPRank, dim: int):
    """Every kv head from each rank's kv heads ``x`` (along ``dim``) on
    the head path: all-gathered over ``model``, each head taken from the
    first rank that computed it (ranks whose query heads read one kv head
    computed it alike).  ``x`` itself off the head path."""
    if plan is None or plan.attn != "heads":
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    import torch.distributed as dist
    dist.all_gather(parts, x, group=tp.group)
    if plan.kv_split:
        return torch.cat(parts, dim)
    heads, have = [], 0
    for r, part in enumerate(parts):
        _, _, lo, hi = plan.heads(cfg, r)
        if hi > have:
            heads.append(part.narrow(dim, have - lo, hi - have))
            have = hi
    return torch.cat(heads, dim)


class _HeadLayers(_GatheredLayers):
    """The layer views of a dense cache leaf (``k``/``v``, (L, B, Smax, K,
    hd), the rank's shard over ``model`` along the sequence or whole) for
    a decode step on the head path, which computes the rank's kv heads
    [kv_lo, kv_hi) only: ``[i]`` gathers layer i over the sequence and
    keeps those heads, (B, Smax, K_loc, hd) contiguous, into which the
    step writes its new rows and which the attention reads (the ranks
    along ``model`` hold different rows, so each gathers every head);
    ``close()`` (also at the next ``[i]``) all-gathers the new rows of
    every rank's heads over ``model`` (``_kv_whole``) and writes those
    that fall into the rank's part of the sequence into its shard.
    ``shape`` is the whole leaf's."""

    def __init__(self, local, spec: tuple, ms: MeshSpec, cfg, plan, tp,
                 pos, S: int):
        super().__init__(local, spec, ms)
        self.cfg, self.plan, self.tp = cfg, plan, tp
        _, _, self.lo, self.hi = plan.heads(cfg, tp.index)
        positions = pos.long()[:, None] + torch.arange(S, device=pos.device)
        self.rows = slab_rows(positions, self.shape[2])

    def __getitem__(self, i: int):
        self.close()
        whole = gather(self.local[i], self.spec, self.ms)
        whole = whole[:, :, self.lo:self.hi].contiguous()
        self.open = (i, whole)
        return whole

    def close(self):
        if self.open is None:
            return
        i, whole = self.open
        self.open = None
        b, p = self.rows
        new = _kv_whole(whole[b, p], self.cfg, self.plan, self.tp, 2)
        local = self.local[i]
        n = local.shape[1]
        q = p - self.ms.index_of(self.spec[1]) * n
        # a row outside the rank's part writes back what it read (no
        # data-dependent shapes: the dry run traces this on meta tensors)
        slots = b[:, 0]
        for j in range(q.shape[1]):
            qj = q[:, j].clamp(0, n - 1)
            inside = ((q[:, j] >= 0) & (q[:, j] < n))[:, None, None]
            local[slots, qj] = torch.where(inside, new[:, j],
                                           local[slots, qj])


def build_prefill_step(cfg: ModelConfig, ms: MeshSpec = None,
                       knobs: StepKnobs = StepKnobs()):
    """Returns ``prefill_step(params, batch) -> (logits, cache)``: the
    last position's logits and the prefill cache, ``lm.prefill`` of
    ``batch["tokens"]`` (and ``batch["frontend"]``, the vlm's patches or
    the encoder's frames).  Under a mesh every rank calls it with its
    parameter shards (``serve_param_specs``) and the whole batch; it
    computes on its data shard, its layers tensor-parallel over ``model``
    (``lm.forward``'s ``tp``; each layer's shards pulled at their use), and
    returns its logits rows (whole over the vocabulary) and its shards of
    the cache (``cache_specs`` of the whole cache; on the head path the
    ranks' kv heads are all-gathered first, ``_kv_whole``)."""
    mk = knobs.model_knobs()
    pspecs = None if ms is None else serve_param_specs(cfg, ms, knobs)
    tp = None if ms is None else tp_rank(ms, pspecs)

    @torch.no_grad()
    def prefill_step(params, batch):
        part, act = _local_batch(batch, ms)
        logits, cache = lm.prefill(params, part.get("tokens"), cfg, mk,
                                   frontend=part.get("frontend"), ms=act,
                                   tp=tp)
        if tp is not None and "k" in cache:
            plan = tp.plan(cfg, cache["k"].shape[2])
            cache = {k: _kv_whole(v, cfg, plan, tp, 3)
                     for k, v in cache.items()}
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
    on its data shard, its layers tensor-parallel over ``model`` as
    ``TPRank.plan`` says (each layer's shards pulled at their use), and
    returns its logits rows.  Each layer's cache is gathered over
    ``model`` whole (``_GatheredLayers``) or, on the head path, as the
    rank's kv heads (``_HeadLayers``)."""
    mk = knobs.model_knobs()
    pspecs = None if ms is None else serve_param_specs(cfg, ms, knobs)
    tp = None if ms is None else tp_rank(ms, pspecs)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        if ms is None:
            return lm.decode_step(params, cache, tokens, pos, cfg, mk)
        part, act = _local_batch({"tokens": tokens, "pos": pos}, ms)
        specs = cache_specs(lm.init_cache_shapes(cfg, tokens.shape[0],
                                                 max_seq), ms)
        plan = None if tp is None else tp.plan(cfg, tokens.shape[1],
                                               decode=True)
        views = {}
        for k, v in cache.items():
            spec = _model_only(specs[k], ms)
            if k in ("k", "v") and plan is not None and plan.attn == "heads":
                views[k] = _HeadLayers(v, spec, ms, cfg, plan, tp,
                                       part["pos"], tokens.shape[1])
            elif not is_whole(spec, ms):
                views[k] = _GatheredLayers(v, spec, ms)
            else:
                views[k] = v
        logits, _ = lm.decode_step(params, views, part["tokens"],
                                   part["pos"], cfg, mk, ms=act, tp=tp)
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
    "tp_only"`` keeps the parameters sharded on ``model`` only, so a step
    gathers over ``model`` alone (what its plan computes whole) instead of
    all-gathering each layer's FSDP shards.  (The port's steps are eager:
    nothing is compiled.)"""
    pshapes = lm.param_shapes(cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, ms, knobs), pshapes
    if shape.kind != "decode":
        raise ValueError(f"jit_serve_step: kind {shape.kind!r} is not a "
                         f"serve step")
    cshapes = lm.init_cache_shapes(cfg, shape.global_batch, shape.seq_len)
    return (build_decode_step(cfg, ms, knobs, max_seq=shape.seq_len),
            (pshapes, cshapes))


# ---------------------------------------------------------------------------
# The serving engine's decode step over a state pool, under a mesh
# ---------------------------------------------------------------------------

def slot_split(n: int, ms: MeshSpec) -> tuple:
    """How a batch of ``n`` slots lies over the data axes, as
    ``batch_specs`` splits a batch: (entry, offset, count) of this rank's
    slots; the entry is None, and the rank holds all ``n``, where ``n``
    does not divide (or every data axis has size 1)."""
    e = fit_act_spec((n,), ("D",), ms)[0]
    if e is None:
        return None, 0, n
    count = n // ms.size_of(e)
    return e, ms.index_of(e) * count, count


def whole_batch(ms: MeshSpec | None) -> MeshSpec | None:
    """The MeshSpec a forward over a batch that every rank holds whole
    sees (a batch-1 prefill, the truncated drafter)."""
    return None if ms is None else dataclasses.replace(ms, batch_axes=())


def _slots_of(cache: dict, o: int, n: int) -> dict:
    """Slots ``o .. o+n`` of a pool's decode cache, sharing its memory: a
    paged pool's table rows over the whole block pool; every leaf of an
    ssm pool narrowed along its slot axis (1), the slab then read through
    the local slots' identity tables, which ``lm.forward`` makes."""
    if "block_tables" in cache:
        return {"k": cache["k"], "v": cache["v"],
                "block_tables": cache["block_tables"][o:o + n]}
    return {k: v.narrow(1, o, n) for k, v in cache.items()
            if k != "slab_tables"}


def _share_rows(cache: dict, local: dict, pos, S: int, split, ms):
    """Every rank's writes of a decode step in every replica of the pool:
    the rows this rank's slots wrote are all-gathered over the data axes
    and written at every slot's rows — paged: the (block, offset) of each
    slot's S positions, then the trash block zeroed (idle slots all write
    there, so its content would depend on the write order); ssm: each
    slot's conv and h state whole, and the hybrid slab's rows at the S
    positions."""
    e, o, n = split
    positions = pos.long()[:, None] + torch.arange(S, device=pos.device)
    if "block_tables" in cache:
        blk, off = paged_rows(positions, cache["block_tables"],
                              cache["k"].shape[2])
        for k in ("k", "v"):
            t = cache[k]
            mine = t[:, blk[o:o + n], off[o:o + n]]      # (L, n, S, K, hd)
            t[:, blk, off] = gather(mine, (None, e, None, None, None), ms)
            t[:, 0].zero_()                              # TRASH_BLOCK
        return
    for k, t in cache.items():
        if k in ("conv", "h"):
            spec = (None, e) + (None,) * (t.dim() - 2)
            t.copy_(gather(local[k], spec, ms))
        elif k in ("shared_k", "shared_v"):
            b, p = slab_rows(positions, t.shape[2])
            mine = local[k][:, b[:n], p[o:o + n]]        # (A, n, S, K, hd)
            t[:, b, p] = gather(mine, (None, e, None, None, None), ms)


def build_pool_decode_step(cfg: ModelConfig, knobs: ModelKnobs,
                           ms: MeshSpec, pspecs=None):
    """Returns ``step(params, cache, tok, pos) -> (logits, cache)``: the
    serving engine's decode step (S = tok.shape[1] tokens a slot: decode,
    the speculative verify, the ssm replay) over a state pool's decode
    cache, written in place, under the mesh ``ms``.  Every rank holds the
    whole pool and calls it with the whole tokens (n, S) and positions
    (n,), and ``params``: its shards per ``pspecs`` (None: whole), pulled
    whole first (``pull``).

    The slots split over the data axes (``slot_split``): the rank decodes
    its own against the pool, then the logits rows and the pool rows of
    every rank are all-gathered and copied into every replica
    (``_share_rows``), so the step returns the whole (n, S, vocab) logits
    and leaves the same pool on every rank.  Where ``n`` does not divide,
    every rank decodes every slot.  At one device nothing moves: the step
    is ``lm.decode_step`` on the parameters given."""

    def step(params, cache, tok, pos):
        p = pull(params, pspecs, ms)
        split = slot_split(tok.shape[0], ms)
        e, o, n = split
        if e is None:
            return lm.decode_step(p, cache, tok, pos, cfg, knobs,
                                  ms=whole_batch(ms))
        act = dataclasses.replace(ms, batch_axes=_entry_axes(e))
        local = _slots_of(cache, o, n)
        logits, _ = lm.decode_step(p, local, tok[o:o + n], pos[o:o + n], cfg,
                                   knobs, ms=act)
        _share_rows(cache, local, pos, tok.shape[1], split, ms)
        return gather(logits, (e, None, None), ms), cache

    return step
