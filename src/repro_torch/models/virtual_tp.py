"""Every rank's part of a tensor-parallel layer in one process.

``lm._attn_apply`` and ``lm._mlp_apply`` compute one rank's part of a
layer of the dense family from its shards and its index alone; the
collectives sit at named points of ``lm._attn_layer`` (``to_model``,
``from_model``, ``gather_rows``).  ``layer`` runs the parts of all ``m``
ranks of ``model`` in turn and does the collectives' work by hand: the
head path's and the MLP's f32 partial sums added and rounded once (as
``from_model``), the sequence path's rows put together (as
``gather_rows``), and ``to_model``'s backward by every rank's part
reading its own bf16 copy of one f32 copy of the input, so autograd adds
their cotangents in f32 and rounds once.  So a
check on one device (the CPU tests, or the card without a second one)
holds the partitioned layer, kernels and all, to the whole layer.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import flatten, unflatten
from repro_torch.distributed.sharding import (AbstractMesh, MeshSpec, TPRank,
                                              param_specs, shard, tp_plan)
from repro_torch.models import common, lm


def rank_params(lp: dict, plan, r: int) -> dict:
    """Rank ``r``'s parameters of a layer (views of ``lp``'s whole
    tensors), as the mesh step's per-layer pull hands them to the layer on
    a (1, m) mesh: the shard its placement gives it (``param_specs``,
    ``sharding.shard``), whole along each axis the pull gathers it over
    (``TPRank.pulled``).  So the cut is the mesh step's own."""
    ms = MeshSpec(AbstractMesh((1, plan.m), ("data", "model"), (0, r)),
                  data_axes=("data",))
    paths, xs = flatten(lp)
    stacked = [torch.empty((1,) + tuple(x.shape), device="meta") for x in xs]
    tp = TPRank(r, plan.m, None, ms,
                param_specs({"layers": unflatten(paths, stacked)}, ms))
    out = []
    for p, x in zip(paths, xs):
        path = f"layers/{p}"
        spec = list(tp.specs[path][1:])
        for dim, _, _ in tp.pulled(path, plan):
            spec[dim] = None
        out.append(shard(x, tuple(spec), ms))
    return unflatten(paths, out)


def _to_model(x, m: int) -> list:
    """``to_model`` by hand: each of ``m`` ranks' input, its own copy in
    x's dtype of one f32 copy of ``x``, so that autograd adds the ranks'
    cotangents in f32 and rounds them once (``x`` itself, for every rank,
    where nothing needs a gradient)."""
    if m == 1 or not x.requires_grad:
        return [x] * m
    xf = x.float()
    return [xf.to(x.dtype) for _ in range(m)]


def _reduce(parts, dtype):
    """``from_model`` by hand: the partials summed in f32, rounded once."""
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total.to(dtype)


def layer(x, lp, cfg, m: int, knobs=lm.ModelKnobs(), positions=None,
          rope=None, caches=None, pos=None, block_tables=None, rows=None,
          slab: bool = False):
    """One dense layer as ``m`` ranks of ``model`` compute it, each rank's
    part run in turn on its parameters (``rank_params``) and combined by
    hand.  ``caches``: in decode, one (k, v) a rank, each holding the kv
    heads that rank computes (``plan.heads``); None in prefill and
    training.  Returns (x, the plan)."""
    B, S, _ = x.shape
    plan = tp_plan(cfg, m, S, decode=caches is not None)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if rope is None:
        rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    xn = _to_model(common.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps),
                   m if plan.attn != "none" else 1)
    shards = [rank_params(lp, plan, r) for r in range(m)]
    outs = [lm._attn_apply(xn[r], shards[r]["attn"], cfg, knobs, positions,
                           rope, None if caches is None else caches[r], pos,
                           block_tables=block_tables, rows=rows, slab=slab,
                           tp=TPRank(r, m), plan=plan)[0]
            for r in (range(m) if plan.attn != "none" else (0,))]
    if plan.attn == "heads":
        h = _reduce(outs, x.dtype)
    elif plan.attn == "seq":
        h = torch.cat(outs, dim=1)
    else:
        h = outs[0]
    x = x + h
    xn = _to_model(common.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps),
                   m if plan.mlp else 1)
    if plan.mlp:
        y = _reduce([lm._mlp_apply(xn[r], shards[r]["mlp"], partial=True)
                     for r in range(m)], x.dtype)
    else:
        y = lm._mlp_apply(xn[0], lp["mlp"])
    return x + y, plan
