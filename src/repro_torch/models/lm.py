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
returns rebuilt arrays): the dense and moe families' KV rows into the
paged pool's ``cache["k"]``/``cache["v"]``, the ssm family's conv window
and SSM state into ``cache["conv"]``/``cache["h"]``, and the hybrid
family's shared block's KV rows into ``cache["shared_k"]``/
``cache["shared_v"]``;
``decode_step`` returns the same dict it was given.

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
                slab=False):
    """Returns (out, new_kv): the (k, v) activations in prefill, the cache
    pair (written in place) in decode.

    ``rope``: the (cos, sin) tables of ``positions``; ``rows``: the
    (block, offset) rows the S >= 1 new tokens write in decode (S > 1 =
    chunked prefill against prior blocks).  The cache is the paged pool
    (NB, bs, K, hd) with the requests' ``block_tables``, or (``slab``) the
    hybrid's dense slab (B, max_seq, K, hd) with ``rows`` from
    ``slab_rows`` and ``block_tables`` its identity tables."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = common.apply_rope_tables(q.reshape(B, S, H, hd), *rope)
    k = common.apply_rope_tables(k.reshape(B, S, K, hd), *rope)
    v = v.reshape(B, S, K, hd)

    if cache is None:                       # prefill
        out = chunked_attention(q, k, v, causal=cfg.causal,
                                q_positions=positions,
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
    return out.reshape(B, S, H * hd) @ p["wo"], new_kv


def _mlp_apply(x, p):
    return (common.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _attn_layer(x, lp, cfg: ModelConfig, knobs: ModelKnobs, positions,
                rope, cache=None, pos=None, block_tables=None, rows=None,
                want_aux: bool = False, ms=None):
    """One layer of the dense and moe families: attention, then the SwiGLU
    MLP or (moe) the routed experts over the B*S tokens.  Returns (x, kv,
    aux): kv as ``_attn_apply``'s; aux the router's load-balancing loss
    with ``want_aux`` (training), else None (the serving paths, where the
    JAX package discards it).  ``ms``: the training mesh, for the moe
    block's expert parallelism."""
    B, S, D = x.shape
    h, kv = _attn_apply(common.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps),
                        lp["attn"], cfg, knobs, positions, rope, cache, pos,
                        block_tables=block_tables, rows=rows)
    x = x + h
    xn = common.rms_norm(x, lp["ln2"]["scale"], cfg.norm_eps)
    if not cfg.uses_moe:
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
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
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

def _embed(params, cfg: ModelConfig, tokens, frontend=None):
    """The layers' input in bf16: the token embeddings; the encoder's
    frames (B, S, F) projected by ``frontend/proj`` in bf16, no token read;
    or (the vlm's patch frontend, given ``frontend`` (B, P, F)) the patches
    projected the same way and put before the tokens, (B, P + T, D)."""
    if cfg.frontend == "frame":             # audio: the whole sequence
        if frontend is None:
            raise ValueError("the frame frontend needs frontend= frames")
        return (frontend.to(torch.bfloat16)
                @ params["frontend"]["proj"].to(torch.bfloat16))
    x = params["embed"]["tokens"][tokens].to(torch.bfloat16)
    if cfg.frontend == "patch" and frontend is not None:
        pat = (frontend.to(torch.bfloat16)
               @ params["frontend"]["proj"].to(torch.bfloat16))
        x = torch.cat([pat, x], dim=1)
    return x


def forward(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), mode: str = "prefill",
            cache=None, pos=None, valid_len=None, frontend=None, ms=None):
    """tokens: (B, S) int, or None for the encoder, whose B and S come
    from ``frontend``.  Returns (hidden (B, S, D), cache).

    Dense, moe, vlm and encoder: the stacked (L, B, S, K, hd) prefill
    activations, or (not the encoder) the paged pool written in place
    (``mode="decode"``, ``pos`` (B,) the first write position).  ssm: the
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

    ``ms`` (train only): the mesh of a mesh step, handed to the moe
    block (expert parallelism); the rest of the forward is the rank's own
    (its batch shard, the pulled parameters)."""
    check_family(cfg)
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode {mode!r}: prefill | decode | train")
    if mode == "decode":
        check_decodes(cfg)
    if frontend is not None and mode == "decode":
        raise ValueError("frontend: a decode step takes tokens only")
    if mode == "train" and cfg.family in ATTN_FAMILIES:
        return _forward_train(params, tokens, cfg, knobs, frontend, ms)
    x = _embed(params, cfg, tokens, frontend)
    if cfg.family in ("ssm", "hybrid"):
        if mode != "prefill" or valid_len is None:
            valid_len = None
        elif not isinstance(valid_len, torch.Tensor):
            valid_len = torch.tensor([valid_len], device=x.device)
        return _forward_ssm(params, x, cfg, knobs, mode, cache, pos,
                            valid_len)
    B, S, D = x.shape
    ar = torch.arange(S, device=x.device)
    if mode == "decode":
        positions = pos.long()[:, None] + ar[None, :]
        bt = cache["block_tables"]
        pos = pos.to(torch.int32)
        rows = paged_rows(positions, bt, cache["k"].shape[2])
    else:
        positions = ar[None, :].expand(B, S)
        bt = rows = None
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        c = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
        x, kv, _ = _attn_layer(x, _layer(params["layers"], i), cfg, knobs,
                               positions, rope, c, pos, block_tables=bt,
                               rows=rows)
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    new_cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
                 if mode == "prefill" else cache)
    x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, new_cache


def _forward_train(params, tokens, cfg: ModelConfig, knobs: ModelKnobs,
                   frontend=None, ms=None):
    """The training forward of the dense, moe, vlm and encoder families: no
    KV kept, nothing written in place; each layer goes through
    ``_maybe_remat``.  Returns (hidden, aux): aux the mean of the layers'
    router losses, as JAX's ``auxs.mean()`` (zeros without experts)."""
    x = _embed(params, cfg, tokens, frontend)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)

    def body(x, lp):
        x, _, aux = _attn_layer(x, lp, cfg, knobs, positions, rope,
                                want_aux=True, ms=ms)
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
                 cache, pos=None, valid_len=None):
    """[mamba1] x L (ssm), or [mamba2] x L with the shared block after
    layers 0, k, 2k, ... (hybrid, k = ``shared_attn_every``).  Decode hands
    each layer views of ``cache["conv"]`` and ``cache["h"]``, which the
    block updates in place, and each application of the shared block its
    slab ``cache["shared_k"][a]`` / ``cache["shared_v"][a]``, read through
    ``cache["slab_tables"]`` (identity block tables; made here when the
    cache has none)."""
    block = mamba1_block if cfg.ssm_version == 1 else mamba2_block
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    if mode == "train":
        return _forward_ssm_train(params, x, cfg, knobs, block, every)
    if every:
        B, S, _ = x.shape
        ar = torch.arange(S, device=x.device)
        rows = tables = None
        if mode == "decode":
            positions = pos.long()[:, None] + ar[None, :]
            pos = pos.to(torch.int32)
            max_seq = cache["shared_k"].shape[2]
            rows = slab_rows(positions, max_seq)
            tables = cache.get("slab_tables")
            if tables is None:
                tables = identity_tables(B, max_seq, x.device)
        else:
            positions = ar[None, :].expand(B, S)
        rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    convs, hs, sk, sv = [], [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
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
            x, kv = _shared_block(x, params["shared"], cfg, knobs, positions,
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
                       block, every: int):
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
        h, _ = block(common.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps),
                     lp["ssm"], cfg)
        x = x + h
        if shared is not None:
            x, _ = _shared_block(x, shared, cfg, knobs, positions, rope)
        return x

    body = _maybe_remat(body, knobs)
    for i in range(cfg.n_layers):
        shared = params["shared"] if every and i % every == 0 else None
        x = body(x, _layer(params["layers"], i), shared)
    return (common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def logits_fn(params, hidden, cfg: ModelConfig):
    w = (params["embed"]["tokens"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return hidden @ w.to(hidden.dtype)


def loss_fn(params, batch, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), ms=None):
    """Mean cross entropy of ``batch["tokens"]`` against ``batch["labels"]``
    (pre-shifted by the data pipeline), with f32 logits, plus
    ``router_aux_weight`` x the mean router aux loss of the moe layers.
    Returns (loss, {"ce", "aux"}) as 0-dim f32 tensors; ``knobs.ce_chunk``
    splits the positions into chunks when it divides S.  With
    ``batch["frontend"]`` vlm patches the loss covers the last S hidden
    positions, the text's; an encoder batch is ``{"frontend", "labels"}``,
    frames with a label each, and the loss covers every frame.  ``ms``:
    the mesh of a mesh step (``forward``); the loss is the rank's, over
    its batch shard."""
    hidden, aux = forward(params, batch.get("tokens"), cfg, knobs,
                          mode="train", frontend=batch.get("frontend"),
                          ms=ms)
    labels = batch["labels"]
    B, S = labels.shape
    if hidden.shape[1] != S:                # vlm: text positions only
        hidden = hidden[:, hidden.shape[1] - S:]

    def ce(h, y):
        lg = logits_fn(params, h, cfg).float()
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
    """Shapes of the ssm and hybrid families' per-slot decode state: conv
    (L, B, Di, K-1) (the pool's dtype) and h (L, B, Di, N) or, for mamba2,
    (L, B, nh, P, N) (always f32); the hybrid adds its shared block's KV
    slab ``shared_k`` / ``shared_v`` (n_apps, B, max_seq, K, hd), the one
    state with a sequence axis, so it needs ``max_seq``.  The dense and moe
    families decode from the paged pool (``init_paged_cache_shapes``)."""
    check_family(cfg)
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} decodes from the paged pool")
    L, Di, B = cfg.n_layers, cfg.d_inner, batch
    out = {"conv": (L, B, Di, cfg.ssm_conv - 1),
           "h": ((L, B, Di, cfg.ssm_state) if cfg.ssm_version == 1 else
                 (L, B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))}
    if cfg.family == "hybrid":
        if max_seq is None:
            raise ValueError("the hybrid family's KV slab needs max_seq")
        slab = (n_shared_apps(cfg), B, max_seq, cfg.n_kv_heads, cfg.hd)
        out.update(shared_k=slab, shared_v=slab)
    return out


def n_shared_apps(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared block: after layers 0, k, 2k,
    ... (k = ``shared_attn_every``)."""
    every = cfg.shared_attn_every
    return -(-cfg.n_layers // every)


def prefill(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), frontend=None):
    """The last position's logits and the prefill cache, as the JAX
    package's ``prefill`` (the encoder: ``tokens=None`` and ``frontend``
    frames; the logits of every frame are ``logits_fn`` of ``forward``'s
    hidden states)."""
    hidden, cache = forward(params, tokens, cfg, knobs, mode="prefill",
                            frontend=frontend)
    return logits_fn(params, hidden[:, -1:], cfg), cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                knobs: ModelKnobs = ModelKnobs()):
    """tokens: (B, S); pos: (B,) write position of the first token (S > 1
    = chunked prefill against the cache).  ``cache``: the paged pool
    (``k``, ``v``, ``block_tables``) or the ssm state (``conv``, ``h``),
    updated in place.  Returns (logits, cache)."""
    hidden, cache = forward(params, tokens, cfg, knobs, mode="decode",
                            cache=cache, pos=pos)
    return logits_fn(params, hidden, cfg), cache
