"""Decoder LM: parameters, prefill, decode and training (the loss), for
the dense family (attention + SwiGLU MLP, paged KV decode), the moe family
(attention + a top-k routed mixture of SwiGLU experts, ``models/moe.py``,
paged KV decode), the vlm family (the dense layers behind a patch
frontend), the encoder family (the dense layers, not causal, over audio
frames: no decode), the ssm family (mamba1 blocks, recurrent-state decode)
and the hybrid family (zamba2: mamba2 blocks and one shared attention +
MLP block applied every ``shared_attn_every`` layers, whose KV lives in a
dense per-slot slab); every family trains.

The port of the JAX package's ``models/lm.py``.  Parameters are a nested
dict of tensors with the JAX tree's keys: layer weights are stacked on a
leading L axis and weight matrices keep JAX's (in, out) orientation, so
``x @ w`` is the JAX einsum.  The layer loop is a Python loop over views
of the stacked tensors.

Decode writes the new state into the cache it is given *in place* (JAX
returns rebuilt arrays): the dense, moe and vlm families' KV rows into the
paged pool's ``cache["k"]``/``cache["v"]`` (with ``block_tables``), or
into the JAX package's dense per-slot cache (``init_cache``: (L, B,
max_seq, K, hd), no tables), the ssm family's conv window and SSM state
into ``cache["conv"]``/``cache["h"]``, and the hybrid family's shared
block's KV rows into ``cache["shared_k"]``/``cache["shared_v"]``;
``decode_step`` returns the same dict it was given.  A dense per-slot
cache is read as the hybrid's slab is: viewed as blocks under identity
tables, through the paged-attention kernel on the card.

Training (``mode="train"``, ``loss_fn``) keeps no KV or recurrent state
and writes nothing in place; autograd runs through it, with each layer
optionally recomputed in the backward (``ModelKnobs.remat``); the moe
family's router aux loss enters the loss.  The ssm and hybrid families'
scan is differentiated by ``models/mamba.py`` ``SelectiveScan`` (the
scan's backward kernel on the card) from the states its forward kept
every ``CHK_STEPS`` steps (the JAX package's ``ssm_chunk`` is not a knob
here).

The vlm family's prefill and training take an optional ``frontend``:
image patches (B, P, frontend_dim), projected by ``frontend/proj`` and put
before the B x T token embeddings, so positions run 0 .. P + T - 1 and the
loss covers the T text positions; its decode (and so its serving) takes
tokens only, as the JAX engine's does.

The encoder family (hubert) reads no token: its prefill (encode) and
training take ``frontend`` frames (B, S, frontend_dim) with ``tokens=None``,
projected by ``frontend/proj``; attention is not causal, the loss covers
every frame, and ``embed/tokens`` is unused.  It has no decode step, so no
paged cache and no serving (``init_paged_cache_shapes``, the pools and the
engine refuse it, as the JAX engine does).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import TPPlan
from repro_torch.models import common
from repro_torch.models.attention import (chunked_attention, decode_attention,
                                          identity_tables,
                                          paged_decode_attention,
                                          slab_decode_attention)
from repro_torch.models.mamba import mamba1_block, mamba2_block
from repro_torch.models.moe import moe_block

ZERO_INIT = ("scale", "bq", "bk", "bv",     # norm gains (1 + scale), biases
             "conv_b", "dt_b", "dt_bias2", "gnorm", "A_log2")


@dataclass(frozen=True)
class ModelKnobs:
    """Per-step system knobs (Type II settings: they change only how the
    step runs, never its result beyond rounding)."""
    k_chunk: int = 1024        # prefill: the flash kernel's block_k (knob)
    attn_impl: str = "paged"   # paged decode: "paged" reads KV blocks in
                               # place (the paged-attention kernel);
                               # "gather" gathers the table into a dense
                               # cache and runs plain attention
    attn_ctx: int = 0          # paged decode: visible block-table columns
                               # (0 = all), chosen per context bucket
    remat: str = "none"        # training: none | dots | full (recompute
                               # each layer in the backward, saving the
                               # projections' and MLP's products or nothing)
    ce_chunk: int = 0          # training: cross entropy over chunks of
                               # this many positions (0 = at once)


ATTN_FAMILIES = ("dense", "moe", "vlm", "encoder")   # attention layers


def check_family(cfg: ModelConfig):
    if (cfg.family in ATTN_FAMILIES
            or (cfg.family == "ssm" and cfg.ssm_version == 1)
            or (cfg.family == "hybrid" and cfg.ssm_version == 2)):
        return
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: the port runs the "
        f"dense, moe, vlm and encoder families, the ssm family (mamba1) and "
        f"the hybrid family (mamba2 + shared attention)")


def check_decodes(cfg: ModelConfig):
    """``check_family``, and refuse the encoder, which has no decode step
    (the JAX engine's and pool's refusal)."""
    check_family(cfg)
    if cfg.family == "encoder":
        raise NotImplementedError(f"family {cfg.family!r}: encoder-only "
                                  f"models have no decode step")


def _pdt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# ===========================================================================
# Parameters
# ===========================================================================

def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of shapes, keyed as the JAX package's ``param_shapes``."""
    check_family(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    F_ = cfg.d_ff
    if cfg.family in ("ssm", "hybrid"):
        Di, N = cfg.d_inner, cfg.ssm_state
        ssm = {"in_proj": (D, 2 * Di), "conv_w": (Di, cfg.ssm_conv),
               "conv_b": (Di,), "out_proj": (Di, D)}
        if cfg.ssm_version == 1:
            R = cfg.dt_rank
            ssm.update({"x_proj": (Di, R + 2 * N), "dt_w": (R, Di),
                        "dt_b": (Di,), "A_log": (Di, N), "Dskip": (Di,)})
        else:
            nh = cfg.n_ssm_heads
            ssm.update({"BC_proj": (D, 2 * N), "dt_proj2": (D, nh),
                        "dt_bias2": (nh,), "A_log2": (nh,), "Dskip2": (nh,),
                        "gnorm": (Di,)})
        layer = {"ln1": {"scale": (D,)}, "ssm": ssm}
    else:
        layer = {"ln1": {"scale": (D,)}, "ln2": {"scale": (D,)},
                 "attn": _attn_shapes(cfg)}
        if cfg.uses_moe:
            E = cfg.n_experts
            layer["moe"] = {"router": (D, E), "wi": (E, D, F_),
                            "wg": (E, D, F_), "wo": (E, F_, D)}
        else:
            layer["mlp"] = {"wi": (D, F_), "wg": (D, F_), "wo": (F_, D)}
    tree = {
        "embed": {"tokens": (V, D)},
        "layers": _map_tree(layer, lambda _, s: (L,) + s),
        "final_norm": {"scale": (D,)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (D, V)}
    if cfg.frontend != "none":
        tree["frontend"] = {"proj": (cfg.frontend_dim, D)}
    if cfg.shared_attn_every:
        # the hybrid's one shared attention + MLP block: not stacked
        tree["shared"] = {"ln1": {"scale": (D,)}, "ln2": {"scale": (D,)},
                          "attn": _attn_shapes(cfg),
                          "mlp": {"wi": (D, F_), "wg": (D, F_),
                                  "wo": (F_, D)}}
    return tree


def _attn_shapes(cfg: ModelConfig) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
         "wo": (H * hd, D)}
    if cfg.qkv_bias:
        p.update({"bq": (H * hd,), "bk": (K * hd,), "bv": (K * hd,)})
    return p


def _map_tree(tree: dict, fn, path=()):
    return {k: (_map_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the CUDA device; raises without one unless ``device`` is
    given): truncated normal on [-2, 2] over sqrt(fan_in), with norm gains
    and biases zero, and the ssm fix-ups ``A_log = log(1..N)``,
    ``A_log2 = 0``, ``dt_bias2 = gnorm = 0`` and ``Dskip = Dskip2 = 1`` —
    the JAX package's distributions, not its numbers.  The moe family's
    stacked expert weights (L, E, in, out) are drawn one (in, out) matrix
    at a time, so the f32 draw stays one matrix (llama4-scout's wi at 12
    layers, (12, 16, 5120, 8192), would be drawn through 32 GB of f32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _pdt(cfg)

    def make(path, shape):
        if path[-1] == "A_log":
            a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=dev))
            return a.expand(shape).to(dt)
        if path[-1] in ("Dskip", "Dskip2"):
            return torch.ones(shape, dtype=dt, device=dev)
        if len(shape) <= 1 or path[-1] in ZERO_INIT:
            return torch.zeros(shape, dtype=dt, device=dev)
        if len(shape) == 4:                 # moe experts (L, E, in, out)
            t = torch.empty(shape, dtype=dt, device=dev)
            for i in range(shape[0]):
                for e in range(shape[1]):
                    t[i, e] = common.dense_init(gen, shape[2:], in_axis=0,
                                                dtype=dt, device=dev)
            return t
        return common.dense_init(gen, shape, in_axis=max(0, len(shape) - 2),
                                 dtype=dt, device=dev)

    return _map_tree(param_shapes(cfg), make)


# ===========================================================================
# Blocks
# ===========================================================================

def paged_rows(positions, block_tables, block_size: int):
    """Physical (block, offset) of each position: position p of request b
    lives at (block_tables[b, p // bs], p % bs).  Positions past the table
    (bucket padding in chunked prefill) go to the pool's trash block 0,
    never onto the last live column."""
    MB = block_tables.shape[1]
    col = torch.clamp(positions // block_size, max=MB - 1)
    blk = torch.gather(block_tables.long(), 1, col)
    blk = torch.where(positions >= MB * block_size, 0, blk)
    return blk, positions % block_size


def _attn_apply(x, p, cfg: ModelConfig, knobs: ModelKnobs, positions, rope,
                cache=None, pos=None, block_tables=None, rows=None,
                slab=False, tp=None, plan: TPPlan = None):
    """Returns (out, new_kv): the (k, v) activations in prefill, the cache
    pair (written in place) in decode.

    ``rope``: the (cos, sin) tables of ``positions``; ``rows``: the
    (block, offset) rows the S >= 1 new tokens write in decode (S > 1 =
    chunked prefill against prior blocks).  The cache is the paged pool
    (NB, bs, K, hd) with the requests' ``block_tables``, or (``slab``) the
    hybrid's dense slab (B, max_seq, K, hd) with ``rows`` from
    ``slab_rows`` and ``block_tables`` its identity tables.

    Rank ``tp.index``'s part under a tensor-parallel ``plan`` (a pure
    function of its shards and its index; the caller reduces): on the
    head path ``p`` holds the column shards of wq (bq) and the row shard
    of wo, and wk, wv (bk, bv) as shards of its kv heads or (not
    ``plan.kv_split``) whole, sliced here to the kv heads its query heads
    read; ``out`` is its partial sum of the output, and the kv and the
    cache its kv heads.  On the sequence path ``p`` is whole and the rank
    computes its query rows against every key, at the rows' own
    positions: ``out`` is its rows.  (The head path's ``out`` is f32,
    ``partial_product``.)"""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    xq, q_pos, q_rope = x, positions, rope
    if plan is not None and plan.attn == "heads":
        q_lo, q_hi, kv_lo, kv_hi = plan.heads(cfg, tp.index)
        if not plan.kv_split:
            c = slice(kv_lo * hd, kv_hi * hd)
            wk, wv = wk[:, c], wv[:, c]
            if cfg.qkv_bias:
                bk, bv = bk[c], bv[c]
        H, K = q_hi - q_lo, kv_hi - kv_lo
    elif plan is not None and plan.attn == "seq":
        lo, hi = plan.rows(S, tp.index)
        xq, q_pos = x[:, lo:hi], positions[:, lo:hi]
        q_rope = tuple(t[:, lo:hi] for t in rope)
    Sq = xq.shape[1]
    q, k, v = xq @ p["wq"], x @ wk, x @ wv
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    q = common.apply_rope_tables(q.reshape(B, Sq, H, hd), *q_rope)
    k = common.apply_rope_tables(k.reshape(B, S, K, hd), *rope)
    v = v.reshape(B, S, K, hd)

    if cache is None:                       # prefill
        out = chunked_attention(q, k, v, causal=cfg.causal,
                                q_positions=q_pos,
                                kv_positions=positions,
                                k_chunk=knobs.k_chunk)
        new_kv = (k, v)
    else:                                   # decode: write, then attend
        k_cache, v_cache = cache
        k_cache[rows] = k.to(k_cache.dtype)
        v_cache[rows] = v.to(v_cache.dtype)
        if slab:
            out = slab_decode_attention(q, k_cache, v_cache, block_tables,
                                        pos=pos)
        elif knobs.attn_impl == "gather":
            NB, bs = k_cache.shape[:2]
            MB = block_tables.shape[1]
            bt = block_tables.long()
            kg = k_cache[bt].reshape(B, MB * bs, K, hd)
            vg = v_cache[bt].reshape(B, MB * bs, K, hd)
            out = decode_attention(q, kg, vg, pos=pos)
        else:
            out = paged_decode_attention(q, k_cache, v_cache, block_tables,
                                         pos=pos, ctx_cols=knobs.attn_ctx)
        new_kv = (k_cache, v_cache)
    out = out.reshape(B, Sq, H * hd)
    if plan is not None and plan.attn == "heads":
        return partial_product(out, p["wo"]), new_kv
    return out @ p["wo"], new_kv


def _mlp_apply(x, p, partial: bool = False):
    """The SwiGLU MLP; ``partial``: ``p`` holds the rank's column shards
    of wi and wg and row shard of wo, and the result is its f32 partial
    sum (``partial_product``)."""
    h = common.silu(x @ p["wg"]) * (x @ p["wi"])
    return partial_product(h, p["wo"]) if partial else h @ p["wo"]


class _PartialProduct(torch.autograd.Function):
    """``a @ w`` of bf16 operands with an f32 result, not rounded: a
    row-parallel product's partial sum, which ``from_model`` sums over
    ``model`` in f32 and rounds once, as the whole product rounds once.
    On the card (and the dry run's meta tensors) ``torch.mm``'s
    ``out_dtype``; on the CPU the product of the operands widened to f32.
    The backward takes the cotangent in the operands' dtype, as the whole
    product's backward does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.device.type == "cpu":
            y = a2.float() @ w.float()
        else:
            y = torch.mm(a2, w, out_dtype=torch.float32)
        return y.view(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        return g @ w.T, a.reshape(-1, a.shape[-1]).T @ g2


def partial_product(a, w):
    """The rank's f32 partial sum of a row-parallel product (``wo`` of the
    attention and of the MLP under tensor parallelism)."""
    return _PartialProduct.apply(a, w)


def _attn_layer(x, lp, cfg: ModelConfig, knobs: ModelKnobs, positions,
                rope, cache=None, pos=None, block_tables=None, rows=None,
                want_aux: bool = False, ms=None, slab: bool = False,
                tp=None, plan: TPPlan = None):
    """One layer of the dense and moe families: attention, then the SwiGLU
    MLP or (moe) the routed experts over the B*S tokens.  Returns (x, kv,
    aux): kv as ``_attn_apply``'s; aux the router's load-balancing loss
    with ``want_aux`` (training), else None (the serving paths, where the
    JAX package discards it).  ``ms``: the mesh of a mesh step, for the
    moe block's expert parallelism.  ``slab``: the cache is the dense
    per-slot cache of one layer (B, max_seq, K, hd).  ``tp``/``plan``:
    the rank's tensor-parallel part (``_attn_apply``, ``_mlp_apply`` on
    its shards) with the collectives at their named points: ``to_model``
    after each norm that feeds a partitioned block, ``from_model`` after
    the row-parallel products, ``gather_rows`` after the sequence path."""
    B, S, D = x.shape
    xn = common.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    attn = "none" if plan is None else plan.attn
    if attn != "none":
        xn = col.to_model(xn, tp.group, tp.size)
    h, kv = _attn_apply(xn, lp["attn"], cfg, knobs, positions, rope, cache,
                        pos, block_tables=block_tables, rows=rows, slab=slab,
                        tp=tp, plan=plan)
    if attn == "heads":
        h = col.from_model(h, tp.group, tp.size, x.dtype)
    elif attn == "seq":
        h = col.gather_rows(h, tp.group, tp.size, tp.index)
    x = x + h
    xn = common.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
    if not cfg.uses_moe:
        if plan is not None and plan.mlp:
            y = _mlp_apply(col.to_model(xn, tp.group, tp.size), lp["mlp"],
                           partial=True)
            return x + col.from_model(y, tp.group, tp.size, x.dtype), kv, \
                None
        return x + _mlp_apply(xn, lp["mlp"]), kv, None
    y, aux = moe_block(xn.reshape(B * S, D), lp["moe"], cfg, ms=ms,
                       want_aux=want_aux)
    return x + y.reshape(B, S, D), kv, aux


def slab_rows(positions, max_seq: int):
    """(slot, position) rows of a dense slab that S >= 1 new tokens write:
    positions clamped to ``max_seq - 1``, as the JAX dense decode clamps
    them (a request never reads a row past its own position)."""
    b = torch.arange(positions.shape[0], device=positions.device)[:, None]
    return b, torch.clamp(positions, max=max_seq - 1)


def _slab_index(cache, key: str, positions):
    """(rows, tables) of a decode step over a dense per-slot cache, whose
    leaf ``cache[key]`` is (L, B, max_seq, K, hd): the rows ``slab_rows``
    writes and the block tables it is read through, the cache's own
    ``slab_tables`` or its identity tables."""
    B, max_seq = positions.shape[0], cache[key].shape[2]
    tables = cache.get("slab_tables")
    if tables is None:
        tables = identity_tables(B, max_seq, positions.device)
    return slab_rows(positions, max_seq), tables


def _shared_block(x, p, cfg: ModelConfig, knobs: ModelKnobs, positions,
                  rope, cache=None, pos=None, tables=None, rows=None):
    """Zamba2's shared attention + MLP block (one weight set, applied every
    ``shared_attn_every`` layers).  Returns (x, kv) as ``_attn_apply``."""
    h, kv = _attn_apply(common.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps),
                        p["attn"], cfg, knobs, positions, rope, cache, pos,
                        block_tables=tables, rows=rows, slab=True)
    x = x + h
    x = x + _mlp_apply(common.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps),
                       p["mlp"])
    return x, kv


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the projections' and the MLP's matrix products (``aten.mm``, what
    ``x @ w`` becomes) and of the moe experts' batched products
    (``aten.bmm``), and recompute the rest.  The flash forward runs again
    in the backward, as in JAX.  (JAX's
    ``checkpoint_dots_with_no_batch_dims`` would recompute the experts'
    products, which have a batch axis; a remat setting changes memory and
    time, never the result.  On the CPU the plain attention's products
    are ``bmm`` too and are kept.)"""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.mm.dtype):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, knobs: ModelKnobs):
    """``fn`` run as it is (``none``), or recomputed in the backward: all
    of it (``full``, nothing saved) or all but its matrix products
    (``dots``)."""
    if knobs.remat == "none":
        return fn
    if knobs.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_products)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if knobs.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat {knobs.remat!r}: none | dots | full")


# ===========================================================================
# Forward
# ===========================================================================

def _embed(params, cfg: ModelConfig, tokens, frontend=None, tp=None):
    """The layers' input in bf16: the token embeddings; the encoder's
    frames (B, S, F) projected by ``frontend/proj`` in bf16, no token read;
    or (the vlm's patch frontend, given ``frontend`` (B, P, F)) the patches
    projected the same way and put before the tokens, (B, P + T, D).
    Under ``tp`` the projection is pulled whole at its use (``_lookup``
    for the table)."""
    def proj():
        w = params["frontend"]["proj"]
        if tp is not None:
            w = tp.pull("frontend/proj", w, TPPlan(tp.size))
        return frontend.to(torch.bfloat16) @ w.to(torch.bfloat16)

    if cfg.frontend == "frame":             # audio: the whole sequence
        if frontend is None:
            raise ValueError("the frame frontend needs frontend= frames")
        return proj()
    x = _lookup(params["embed"]["tokens"], tokens, cfg, tp)
    if cfg.frontend == "patch" and frontend is not None:
        x = torch.cat([proj(), x], dim=1)
    return x


def _lookup(table, tokens, cfg: ModelConfig, tp=None):
    """The token embeddings in bf16.  Under ``tp`` the table is pulled
    whole at its use, unless the plan splits the vocabulary: then each
    rank looks up the tokens of its rows of the table (zeros for the rest)
    and the lookups are summed over ``model`` (``from_model``: exact, one
    rank's row is nonzero), Megatron's vocabulary-parallel embedding."""
    if tp is None:
        return table[tokens].to(torch.bfloat16)
    plan = tp.plan(cfg, 1)
    if not plan.vocab:
        return tp.pull("embed/tokens", table, plan)[tokens].to(
            torch.bfloat16)
    w = tp.pull("embed/tokens", table, plan, "logits")
    n = w.shape[0]
    local = tokens.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = w[local.clamp(0, n - 1)].to(torch.bfloat16)
    return col.from_model(torch.where(inside[..., None], rows, 0),
                          tp.group, tp.size)


def _pulled(tp, prefix: str, tree: dict, plan) -> dict:
    """A layer's (or the shared block's) parameters as the rank computes
    with them: ``tree`` itself without ``tp``."""
    return tree if tp is None else tp.pull_tree(prefix, tree, plan)


def forward(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), mode: str = "prefill",
            cache=None, pos=None, valid_len=None, frontend=None, ms=None,
            tp=None):
    """tokens: (B, S) int, or None for the encoder, whose B and S come
    from ``frontend``.  Returns (hidden (B, S, D), cache).

    Dense, moe, vlm and encoder: the stacked (L, B, S, K, hd) prefill
    activations, or (not the encoder) the cache written in place
    (``mode="decode"``, ``pos`` (B,) the first write position): the paged
    pool with its ``block_tables``, or the dense per-slot cache
    (``init_cache``) without, whose rows are written at ``pos`` clamped to
    max_seq - 1 (``slab_rows``) and read through ``identity_tables`` (or
    the cache's own ``slab_tables``).  ssm: the
    stacked prefill state (conv (L, B, Di, K-1), h (L, B, Di, N) f32), or
    the decode cache written in place (``pos`` is not read).  hybrid: the
    same with h (L, B, nh, P, N), and the shared block's KV, (n_apps, B,
    S, K, hd) in prefill or the slab ``shared_k``/``shared_v`` (n_apps, B,
    max_seq, K, hd) written in place at ``pos`` in decode.

    ``mode="train"``: no cache (None), nothing written in place, each
    layer under ``knobs.remat`` (the hybrid's shared block with the layer
    it follows); returns (hidden, aux), aux the mean of the layers' router
    losses (0 for the families without experts).

    ``valid_len`` (int or (1,) int64 tensor, prefill only): non-pad tokens
    of a right-padded batch.  Attention ignores it (the causal mask and the
    caller's slicing isolate pads); the ssm family returns the state *after
    token valid_len*, not after the pads.  A tensor stays on the device, so
    a captured prefill serves every valid_len of its bucket.

    ``frontend`` (prefill and train only): the vlm's image patches (B, P,
    F) before the tokens, the hidden states then covering P + S
    positions, or the encoder's frames (B, S, F) (``_embed``).

    ``ms``: the mesh of a mesh step (training or serving), handed to the
    moe block (expert parallelism); the rest of the forward is the rank's
    own (its batch shard, its cache gathered).

    ``tp`` (a ``sharding.TPRank``, set only by the steps that hand the
    model the rank's shards): ``params`` are the rank's shards, pulled
    layer by layer at their use (``TPRank.pull``), and the attention
    families' layers compute tensor-parallel over ``model`` as
    ``tp.plan`` says (``_attn_layer``); the ssm and hybrid families
    compute whole on every rank.  Without it the parameters are whole."""
    check_family(cfg)
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode {mode!r}: prefill | decode | train")
    if mode == "decode":
        check_decodes(cfg)
    if frontend is not None and mode == "decode":
        raise ValueError("frontend: a decode step takes tokens only")
    if mode == "train" and cfg.family in ATTN_FAMILIES:
        return _forward_train(params, tokens, cfg, knobs, frontend, ms, tp)
    x = _embed(params, cfg, tokens, frontend, tp)
    if cfg.family in ("ssm", "hybrid"):
        if mode != "prefill" or valid_len is None:
            valid_len = None
        elif not isinstance(valid_len, torch.Tensor):
            valid_len = torch.tensor([valid_len], device=x.device)
        return _forward_ssm(params, x, cfg, knobs, mode, cache, pos,
                            valid_len, tp)
    B, S, D = x.shape
    plan = None if tp is None else tp.plan(cfg, S, decode=mode == "decode")
    ar = torch.arange(S, device=x.device)
    slab = mode == "decode" and "block_tables" not in cache
    if mode == "decode":
        positions = pos.long()[:, None] + ar[None, :]
        pos = pos.to(torch.int32)
        if slab:                            # the dense per-slot cache
            rows, bt = _slab_index(cache, "k", positions)
        else:
            bt = cache["block_tables"]
            rows = paged_rows(positions, bt, cache["k"].shape[2])
    else:
        positions = ar[None, :].expand(B, S)
        bt = rows = None
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        c = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
        lp = _pulled(tp, "layers", _layer(params["layers"], i), plan)
        x, kv, _ = _attn_layer(x, lp, cfg, knobs, positions, rope, c, pos,
                               block_tables=bt, rows=rows, ms=ms, slab=slab,
                               tp=tp, plan=plan)
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    new_cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
                 if mode == "prefill" else cache)
    x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, new_cache


def _forward_train(params, tokens, cfg: ModelConfig, knobs: ModelKnobs,
                   frontend=None, ms=None, tp=None):
    """The training forward of the dense, moe, vlm and encoder families: no
    KV kept, nothing written in place; each layer goes through
    ``_maybe_remat`` (with ``tp``, its pull too, so a recomputed layer
    gathers again).  Returns (hidden, aux): aux the mean of the layers'
    router losses, as JAX's ``auxs.mean()`` (zeros without experts)."""
    x = _embed(params, cfg, tokens, frontend, tp)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    plan = None if tp is None else tp.plan(cfg, S)

    def body(x, lp):
        x, _, aux = _attn_layer(x, _pulled(tp, "layers", lp, plan), cfg,
                                knobs, positions, rope, want_aux=True, ms=ms,
                                tp=tp, plan=plan)
        return x, aux

    body = _maybe_remat(body, knobs)
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = body(x, _layer(params["layers"], i))
        auxs.append(aux)
    aux = (torch.stack(auxs).mean() if cfg.uses_moe else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return (common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps),
            aux)


def _forward_ssm(params, x, cfg: ModelConfig, knobs: ModelKnobs, mode: str,
                 cache, pos=None, valid_len=None, tp=None):
    """[mamba1] x L (ssm), or [mamba2] x L with the shared block after
    layers 0, k, 2k, ... (hybrid, k = ``shared_attn_every``).  Decode hands
    each layer views of ``cache["conv"]`` and ``cache["h"]``, which the
    block updates in place, and each application of the shared block its
    slab ``cache["shared_k"][a]`` / ``cache["shared_v"][a]``, read through
    ``cache["slab_tables"]`` (identity block tables; made here when the
    cache has none).  ``tp``: each layer's and each application's
    parameters pulled whole at their use."""
    block = mamba1_block if cfg.ssm_version == 1 else mamba2_block
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    plan = None if tp is None else TPPlan(tp.size)
    if mode == "train":
        return _forward_ssm_train(params, x, cfg, knobs, block, every, tp,
                                  plan)
    if every:
        B, S, _ = x.shape
        ar = torch.arange(S, device=x.device)
        rows = tables = None
        if mode == "decode":
            positions = pos.long()[:, None] + ar[None, :]
            pos = pos.to(torch.int32)
            rows, tables = _slab_index(cache, "shared_k", positions)
        else:
            positions = ar[None, :].expand(B, S)
        rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    convs, hs, sk, sv = [], [], [], []
    for i in range(cfg.n_layers):
        lp = _pulled(tp, "layers", _layer(params["layers"], i), plan)
        st = ({"conv": cache["conv"][i], "h": cache["h"][i]}
              if mode == "decode" else None)
        h, new_st = block(common.rms_norm(x, lp["ln1"]["scale"],
                                          cfg.norm_eps),
                          lp["ssm"], cfg, st, valid_len)
        x = x + h
        if mode == "prefill":
            convs.append(new_st["conv"])
            hs.append(new_st["h"])
        if every and i % every == 0:
            a = i // every
            c = ((cache["shared_k"][a], cache["shared_v"][a])
                 if mode == "decode" else None)
            x, kv = _shared_block(x, _pulled(tp, "shared", params["shared"],
                                             plan), cfg, knobs, positions,
                                  rope, c, pos, tables, rows)
            if mode == "prefill":
                sk.append(kv[0])
                sv.append(kv[1])
    if mode == "prefill":
        new_cache = {"conv": torch.stack(convs), "h": torch.stack(hs)}
        if every:
            new_cache.update(shared_k=torch.stack(sk),
                             shared_v=torch.stack(sv))
    else:
        new_cache = cache
    x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, new_cache


def _forward_ssm_train(params, x, cfg: ModelConfig, knobs: ModelKnobs,
                       block, every: int, tp=None, plan=None):
    """``_forward_ssm``'s training branch (JAX's ``want_state = False``): no
    state kept, nothing written in place; each layer, with the hybrid's
    shared block after layers 0, k, 2k, ... (attention through
    ``FlashAttention`` on the card), under ``_maybe_remat``.  Returns (hidden, zero
    aux), as JAX's ``_forward_ssm``."""
    rope = positions = None
    if every:
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)

    def body(x, lp, shared):
        lp = _pulled(tp, "layers", lp, plan)
        h, _ = block(common.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps),
                     lp["ssm"], cfg)
        x = x + h
        if shared is not None:
            x, _ = _shared_block(x, _pulled(tp, "shared", shared, plan), cfg,
                                 knobs, positions, rope)
        return x

    body = _maybe_remat(body, knobs)
    for i in range(cfg.n_layers):
        shared = params["shared"] if every and i % every == 0 else None
        x = body(x, _layer(params["layers"], i), shared)
    return (common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def logits_fn(params, hidden, cfg: ModelConfig, tp=None, plan=None):
    """``hidden @ w``: under ``tp`` the rank's columns of the vocabulary
    where ``plan.vocab`` (its weight shard pulled over the data axes, the
    hidden states behind ``to_model``), else every column."""
    if cfg.tie_embeddings:
        w = params["embed"]["tokens"]
        w = (w if tp is None else tp.pull("embed/tokens", w, plan,
                                          "logits")).T
    else:
        w = params["lm_head"]["w"]
        if tp is not None:
            w = tp.pull("lm_head/w", w, plan, "logits")
    if plan is not None and plan.vocab:
        hidden = col.to_model(hidden, tp.group, tp.size)
    return hidden @ w.to(hidden.dtype)


def _whole_logits(params, hidden, cfg: ModelConfig, tp=None):
    """The serve steps' logits: ``logits_fn``, the rank's vocabulary
    columns all-gathered over ``model`` under a vocabulary-parallel plan."""
    plan = None if tp is None else tp.plan(cfg, hidden.shape[1])
    lg = logits_fn(params, hidden, cfg, tp, plan)
    if plan is not None and plan.vocab:
        lg = col._all_gather_dim(lg, tp.group, tp.size, lg.dim() - 1)
    return lg


def _vocab_parallel_ce(lg, y, tp):
    """Summed cross entropy of f32 logits whose last axis is the rank's
    columns of the vocabulary: the rows' max all-reduced (MAX, outside the
    gradient: the log-sum-exp's gradient does not depend on it), the sum
    of exponentials and the target's logit all-reduced (``from_model``)."""
    import torch.distributed as dist
    Vl = lg.shape[-1]
    with torch.no_grad():
        mx = lg.amax(-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=tp.group)
    se = col.from_model(torch.exp(lg - mx[..., None]).sum(-1), tp.group,
                        tp.size)
    local = y.long() - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    t = torch.gather(lg, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = col.from_model(torch.where(inside, t, 0.0), tp.group, tp.size)
    return (mx + torch.log(se) - tgt).sum()


def loss_fn(params, batch, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), ms=None, tp=None):
    """Mean cross entropy of ``batch["tokens"]`` against ``batch["labels"]``
    (pre-shifted by the data pipeline), with f32 logits, plus
    ``router_aux_weight`` x the mean router aux loss of the moe layers.
    Returns (loss, {"ce", "aux"}) as 0-dim f32 tensors; ``knobs.ce_chunk``
    splits the positions into chunks when it divides S.  With
    ``batch["frontend"]`` vlm patches the loss covers the last S hidden
    positions, the text's; an encoder batch is ``{"frontend", "labels"}``,
    frames with a label each, and the loss covers every frame.  ``ms``:
    the mesh of a mesh step (``forward``); the loss is the rank's, over
    its batch shard.  ``tp``: the rank's shards (``forward``), the logits
    vocabulary-parallel where the plan says so (``_vocab_parallel_ce``:
    every rank of ``model`` the same loss)."""
    hidden, aux = forward(params, batch.get("tokens"), cfg, knobs,
                          mode="train", frontend=batch.get("frontend"),
                          ms=ms, tp=tp)
    labels = batch["labels"]
    B, S = labels.shape
    if hidden.shape[1] != S:                # vlm: text positions only
        hidden = hidden[:, hidden.shape[1] - S:]

    plan = None if tp is None else tp.plan(cfg, S)

    def ce(h, y):
        lg = logits_fn(params, h, cfg, tp, plan).float()
        if plan is not None and plan.vocab:
            return _vocab_parallel_ce(lg, y, tp)
        tgt = torch.gather(lg, -1, y[..., None].long())[..., 0]
        return (torch.logsumexp(lg, dim=-1) - tgt).sum()

    c = knobs.ce_chunk
    if c and S > c and S % c == 0:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for j in range(0, S, c):
            total = total + ce(hidden[:, j:j + c], labels[:, j:j + c])
    else:
        total = ce(hidden, labels)
    loss = total / (B * S)
    return loss + cfg.router_aux_weight * aux, {"ce": loss, "aux": aux}


# ===========================================================================
# Serving entry points
# ===========================================================================

def init_paged_cache_shapes(cfg: ModelConfig, n_blocks: int,
                            block_size: int) -> dict:
    """Shapes of a paged decode cache: (L, NB, bs, K, hd) for k and v.
    Attention families with a decode step only: recurrent state has no
    sequence axis to page, and the encoder does not decode."""
    check_decodes(cfg)
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no paged KV cache")
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


def init_cache_shapes(cfg: ModelConfig, batch: int,
                      max_seq: int | None = None) -> dict:
    """Shapes of the per-slot decode cache, as the JAX package's: the
    attention families' dense k and v (L, B, max_seq, K, hd); the ssm and
    hybrid families' conv (L, B, Di, K-1) and h (L, B, Di, N) or, for
    mamba2, (L, B, nh, P, N), the hybrid adding its shared block's KV slab
    ``shared_k`` / ``shared_v`` (n_apps, B, max_seq, K, hd).  ``max_seq``
    is needed wherever a state has a sequence axis.  (The engine's dense
    and moe pools page their KV instead: ``init_paged_cache_shapes``.)"""
    check_family(cfg)
    L, B = cfg.n_layers, batch
    if cfg.family in ATTN_FAMILIES:
        if max_seq is None:
            raise ValueError(f"family {cfg.family!r}: the KV cache needs "
                             f"max_seq")
        kv = (L, B, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": kv, "v": kv}
    Di = cfg.d_inner
    out = {"conv": (L, B, Di, cfg.ssm_conv - 1),
           "h": ((L, B, Di, cfg.ssm_state) if cfg.ssm_version == 1 else
                 (L, B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))}
    if cfg.family == "hybrid":
        if max_seq is None:
            raise ValueError("the hybrid family's KV slab needs max_seq")
        slab = (n_shared_apps(cfg), B, max_seq, cfg.n_kv_heads, cfg.hd)
        out.update(shared_k=slab, shared_v=slab)
    return out


def cache_dtype(name: str):
    """A decode cache leaf's dtype, the JAX package's: the SSM state ``h``
    f32, the rest (KV, the conv window) bf16."""
    return torch.float32 if name == "h" else torch.bfloat16


def init_cache(cfg: ModelConfig, batch: int, max_seq: int | None = None,
               device=None) -> dict:
    """The zeroed per-slot decode cache of ``init_cache_shapes`` on
    ``device`` (default: the CUDA device; raises without one unless
    ``device`` is given), in ``cache_dtype``'s dtypes."""
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=cache_dtype(k), device=dev)
            for k, s in init_cache_shapes(cfg, batch, max_seq).items()}


def n_shared_apps(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared block: after layers 0, k, 2k,
    ... (k = ``shared_attn_every``)."""
    every = cfg.shared_attn_every
    return -(-cfg.n_layers // every)


def prefill(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), frontend=None, ms=None,
            tp=None):
    """The last position's logits and the prefill cache, as the JAX
    package's ``prefill`` (the encoder: ``tokens=None`` and ``frontend``
    frames; the logits of every frame are ``logits_fn`` of ``forward``'s
    hidden states).  ``ms``: the mesh of a serve step (the moe block's
    expert parallelism); ``tp``: the rank's shards (``forward``), the
    logits whole and the cache's kv heads the rank's."""
    hidden, cache = forward(params, tokens, cfg, knobs, mode="prefill",
                            frontend=frontend, ms=ms, tp=tp)
    return _whole_logits(params, hidden[:, -1:], cfg, tp), cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                knobs: ModelKnobs = ModelKnobs(), ms=None, tp=None):
    """tokens: (B, S); pos: (B,) write position of the first token (S > 1
    = chunked prefill against the cache).  ``cache``: the paged pool
    (``k``, ``v``, ``block_tables``), the dense per-slot cache (``k``,
    ``v``: ``init_cache``) or the ssm state (``conv``, ``h``), updated in
    place.  ``ms``: the mesh of a serve step (the moe block's expert
    parallelism); ``tp``: the rank's shards (``forward``; the attention
    families' cache leaves then hold the rank's kv heads).  Returns
    (logits, cache)."""
    hidden, cache = forward(params, tokens, cfg, knobs, mode="decode",
                            cache=cache, pos=pos, ms=ms, tp=tp)
    return _whole_logits(params, hidden, cfg, tp), cache
