"""Dense decoder LM: parameters, prefill and paged decode.

The port of the JAX package's ``models/lm.py`` for the dense family.
Parameters are a nested dict of tensors with the JAX tree's keys: layer
weights are stacked on a leading L axis and weight matrices keep JAX's
(in, out) orientation, so ``x @ w`` is the JAX einsum.  The layer loop is
a Python loop over views of the stacked tensors.

Decode writes the new KV rows into the paged pool *in place* (JAX returns
rebuilt arrays): ``cache["k"]``/``cache["v"]`` are the pool's own tensors,
and ``decode_step`` returns the same dict it was given.

Other families (moe, ssm, hybrid, vlm, encoder) are served by later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.attention import (chunked_attention, decode_attention,
                                          paged_decode_attention)

ZERO_INIT = ("scale", "bq", "bk", "bv")     # norm gains (1 + scale), biases


@dataclass(frozen=True)
class ModelKnobs:
    """Per-step system knobs (Type II settings: they change only how the
    step runs, never its result beyond rounding)."""
    k_chunk: int = 1024        # prefill: KV tile of the flash kernel
    attn_impl: str = "paged"   # paged decode: "paged" reads KV blocks in
                               # place (the paged-attention kernel);
                               # "gather" gathers the table into a dense
                               # cache and runs plain attention
    attn_ctx: int = 0          # paged decode: visible block-table columns
                               # (0 = all), chosen per context bucket


def check_family(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: this slice of the "
            f"port serves the dense family; moe, ssm, hybrid, vlm and "
            f"encoder come with the 'other families' slice")


def _pdt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# ===========================================================================
# Parameters
# ===========================================================================

def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of shapes, keyed as the JAX package's ``param_shapes``."""
    check_family(cfg)
    L, D, H, K, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.hd)
    F_, V = cfg.d_ff, cfg.vocab_size
    attn = {"wq": (L, D, H * hd), "wk": (L, D, K * hd), "wv": (L, D, K * hd),
            "wo": (L, H * hd, D)}
    if cfg.qkv_bias:
        attn.update({"bq": (L, H * hd), "bk": (L, K * hd), "bv": (L, K * hd)})
    tree = {
        "embed": {"tokens": (V, D)},
        "layers": {"ln1": {"scale": (L, D)}, "ln2": {"scale": (L, D)},
                   "attn": attn,
                   "mlp": {"wi": (L, D, F_), "wg": (L, D, F_),
                           "wo": (L, F_, D)}},
        "final_norm": {"scale": (D,)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (D, V)}
    return tree


def _map_tree(tree: dict, fn, path=()):
    return {k: (_map_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the CUDA device; raises without one unless ``device`` is
    given): truncated normal on [-2, 2] over sqrt(fan_in), with norm gains
    and biases zero — the JAX package's distributions, not its numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _pdt(cfg)

    def make(path, shape):
        if len(shape) <= 1 or path[-1] in ZERO_INIT:
            return torch.zeros(shape, dtype=dt, device=dev)
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
                cache=None, pos=None, block_tables=None, rows=None):
    """Returns (out, new_kv): the (k, v) activations in prefill, the paged
    pool pair (written in place) in decode.

    ``rope``: the (cos, sin) tables of ``positions``; ``rows``: the
    ``paged_rows`` the S >= 1 new tokens write in decode (S > 1 = chunked
    prefill against prior blocks)."""
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
    else:                                   # decode: paged (NB, bs, K, hd)
        k_cache, v_cache = cache
        k_cache[rows] = k.to(k_cache.dtype)
        v_cache[rows] = v.to(v_cache.dtype)
        if knobs.attn_impl == "gather":
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
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ===========================================================================
# Forward
# ===========================================================================

def forward(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs(), mode: str = "prefill",
            cache=None, pos=None):
    """tokens: (B, S) int.  Returns (hidden (B, S, D), cache): the stacked
    (L, B, S, K, hd) prefill activations, or the paged pool written in
    place (``mode="decode"``, ``pos`` (B,) the first write position)."""
    check_family(cfg)
    x = params["embed"]["tokens"][tokens].to(torch.bfloat16)
    B, S, D = x.shape
    ar = torch.arange(S, device=x.device)
    if mode == "decode":
        positions = pos.long()[:, None] + ar[None, :]
        bt = cache["block_tables"]
        pos = pos.to(torch.int32)
        rows = paged_rows(positions, bt, cache["k"].shape[2])
    elif mode == "prefill":
        positions = ar[None, :].expand(B, S)
        bt = rows = None
    else:
        raise NotImplementedError(
            f"mode {mode!r}: training comes with the training slice")
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        c = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
        h, kv = _attn_apply(common.rms_norm(x, lp["ln1"]["scale"],
                                            cfg.norm_eps),
                            lp["attn"], cfg, knobs, positions, rope, c, pos,
                            block_tables=bt, rows=rows)
        x = x + h
        x = x + _mlp_apply(common.rms_norm(x, lp["ln2"]["scale"],
                                           cfg.norm_eps), lp["mlp"])
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    new_cache = ({"k": torch.stack(ks), "v": torch.stack(vs)}
                 if mode == "prefill" else cache)
    x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, new_cache


def logits_fn(params, hidden, cfg: ModelConfig):
    w = (params["embed"]["tokens"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return hidden @ w.to(hidden.dtype)


# ===========================================================================
# Serving entry points
# ===========================================================================

def init_paged_cache_shapes(cfg: ModelConfig, n_blocks: int,
                            block_size: int) -> dict:
    """Shapes of a paged decode cache: (L, NB, bs, K, hd) for k and v."""
    check_family(cfg)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape}


def prefill(params, tokens, cfg: ModelConfig,
            knobs: ModelKnobs = ModelKnobs()):
    hidden, cache = forward(params, tokens, cfg, knobs, mode="prefill")
    return logits_fn(params, hidden[:, -1:], cfg), cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                knobs: ModelKnobs = ModelKnobs()):
    """tokens: (B, S); pos: (B,) write position of the first token (S > 1
    = chunked prefill against the cache).  ``cache``: the paged pool
    (``k``, ``v``, ``block_tables``), updated in place.  Returns (logits,
    cache)."""
    hidden, cache = forward(params, tokens, cfg, knobs, mode="decode",
                            cache=cache, pos=pos)
    return logits_fn(params, hidden, cfg), cache
