"""Top-k routed mixture of experts with sort-based capacity dispatch, the
port of the JAX package's ``models/moe.py`` on one device (one token
group, G = 1).

Each token's router picks its top-k experts; the (token, expert) pairs
are sorted by expert (stably, so a token keeps its place within an
expert), and each expert takes its first C pairs, C from ``_capacity``
and the static token count, so every shape is known before the step
runs.  A pair past an expert's capacity is dropped: its token gets no
output from that expert.  The expert products are plain batched matrix
products over the (E, C, D) buffer (the JAX package computes them
outside any Pallas kernel), and the combine adds a token's k weighted
outputs in the sorted (expert-ascending) order, in bf16 as the JAX
scatter-add does.

Nothing in the block reads a value back to the host (no ``nonzero``, no
boolean-mask indexing, no ``.item()``): a decode, verify or prefill step
with moe layers is captured as one CUDA graph.  Nothing adds with atomics
either (no ``index_add_`` / ``scatter_add_``), so top-k > 1 is
deterministic on the card.

Over a mesh (the mesh train step) ``moe_block`` runs the JAX package's
expert parallelism, ``moe_block_ep``, under the same condition and with
the same fallbacks (counted in ``DISPATCH``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import collectives as col
from repro_torch.models import common

# the paths moe_block took under a mesh: "ep", or the single-group
# fallbacks "tokens" (T % dp or T / dp < top_k) and "experts" (E % tp)
DISPATCH = {"ep": 0, "tokens": 0, "experts": 0}


def _capacity(tokens_per_group: int, topk: int, n_experts: int,
              cf: float) -> int:
    cap = int(max(topk, round(tokens_per_group * topk / n_experts * cf)))
    # tiny token counts (decode steps) must never drop: the steady-state
    # capacity-factor model only holds at large T
    cap = max(cap, min(tokens_per_group * topk, 16))
    return min(cap, tokens_per_group * topk)


@contextlib.contextmanager
def _ieee_f32(device: torch.device):
    """f32 matrix products in full precision on the card, whatever the
    process's TF32 setting: the router's gate is an f32 product in the
    JAX package, and TF32's 10-bit mantissa would move near-tied router
    margins across each other."""
    if device.type != "cuda":
        yield
        return
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def _route(x, router, topk: int):
    """x (T, D) -> (probs (T, E) f32, topw (T, k) renormalised, topi (T, k)
    int64).  The top k are taken from a stable descending sort, so among
    equal probabilities the lower expert comes first, as in
    ``jax.lax.top_k``."""
    with _ieee_f32(x.device):
        logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = srt.values[:, :topk], srt.indices[:, :topk]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return probs, topw, topi


def _aux_loss(probs, topi, n_experts: int):
    """Switch-style load balancing: E x sum_e (share of tokens whose first
    choice is e) x (mean router probability of e)."""
    ar = torch.arange(n_experts, device=probs.device)
    density = (topi[:, :1] == ar).float().mean(0)
    return n_experts * torch.sum(density * probs.mean(0))


def _dispatch(x, topw, topi, n_experts: int, cap: int):
    """The sorted dispatch of ``x`` (T, D) by its routing.  Returns xe (E,
    C, D), the combine metadata (se, pos, tok, keep, w_sorted) of the T*k
    (token, expert) pairs in sorted order, as JAX's ``_local_dispatch``,
    and ``order`` (sorted position -> flat pair index t * k + j).

    Slot (e, c) of xe holds the token of expert e's c-th sorted pair, or
    zeros when e has at most c pairs: the buffer JAX's
    ``.at[se, pos].set(..., mode="drop")`` builds, made by a gather, so no
    two writes meet and pairs at ``pos >= C`` are simply never read."""
    T, _ = x.shape
    k = topi.shape[1]
    dev = x.device
    flat_e = topi.reshape(-1)                                 # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    tok = order // k
    counts = (flat_e[:, None]
              == torch.arange(n_experts, device=dev)).sum(0)  # (E,)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - offsets[se]
    keep = pos < cap
    slot = torch.arange(cap, device=dev)
    filled = slot[None, :] < counts[:, None]                  # (E, C)
    src = torch.where(filled, offsets[:, None] + slot[None, :], 0)
    xe = torch.where(filled[..., None], x[tok[src]], 0)
    w_sorted = topw.reshape(-1)[order]
    return xe, (se, pos, tok, keep, w_sorted), order


def _local_dispatch(xl, router, cfg):
    """Per-shard routing: xl (Tl, D) -> (xe (E, C, D), aux, meta) with meta
    = (se, pos, tok, keep, w_sorted, C), JAX's ``_local_dispatch``, for
    the mesh's ``moe_block_ep`` to call (on one device ``moe_block`` runs
    the same ``_route`` and ``_dispatch``)."""
    E, topk = cfg.n_experts, cfg.moe_top_k
    probs, topw, topi = _route(xl, router, topk)
    cap = _capacity(xl.shape[0], topk, E, cfg.capacity_factor)
    xe, meta, _ = _dispatch(xl, topw, topi, E, cap)
    return xe, _aux_loss(probs, topi, E), meta + (cap,)


def _experts(xe, p):
    """SwiGLU of each expert over its (C, D) slab: (E, C, D) -> (E, C, D)."""
    h = torch.bmm(xe, p["wi"])
    g = torch.bmm(xe, p["wg"])
    return torch.bmm(common.silu(g) * h, p["wo"])


def _combine(y, se, pos, w, tok, T: int, k: int):
    """The experts' outputs (E, C, D) -> (T, D): each pair's row times its
    gate weight ``w`` (cast to bf16 first, zero for a dropped pair), then a
    token's k rows added in sorted (expert-ascending) order onto zeros, as
    JAX's bf16 scatter-add adds them; here a gather of each token's k
    rows, so nothing adds with atomics."""
    cap = y.shape[1]
    y_tok = y[se, torch.clamp(pos, max=cap - 1)] * w.to(y.dtype)[:, None]
    # rows[t]: where token t's k pairs sit in the sorted order, ascending
    # (a stable sort of the pairs' tokens), i.e. in expert-ascending order
    rows = torch.argsort(tok, stable=True).view(T, k)
    out = torch.zeros((T, y.shape[-1]), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + y_tok[rows[:, j]]
    return out


def _share(ms) -> tuple[int, int]:
    """(shards, index): how many equal parts of the global tokens the
    ranks' activations split into over the data axes, and this rank's."""
    axes = ms.data_axes if ms.batch_axes is None else ms.batch_axes
    if not axes:
        return 1, 0
    return ms.size_of(axes), ms.index_of(axes)


def moe_block(x, params, cfg, ms=None, want_aux: bool = True):
    """x: (T, D) flattened tokens -> (out (T, D), aux_loss 0-dim f32, or
    None without ``want_aux``: the serving paths do not compute the loss
    the JAX package computes and discards there).

    ``ms``: the mesh of a mesh step, ``x`` then the rank's part of the
    tokens (``ms.batch_axes``).  As in the JAX package, expert
    parallelism runs when the mesh has more than one device, the global
    T divides over the data axes and each data shard has at least top_k
    tokens; otherwise (and when E % tp != 0) the single-group path runs
    over the global tokens."""
    if ms is None or ms.n_devices == 1:
        return _moe_block_gspmd(x, params, cfg, want_aux=want_aux)
    dp = ms.data_size
    T = x.shape[0] * _share(ms)[0]
    if T % dp == 0 and T // dp >= cfg.moe_top_k:
        return moe_block_ep(x, params, cfg, ms)
    DISPATCH["tokens"] += 1
    return _moe_block_global(x, params, cfg, ms)


def _moe_block_gspmd(x, params, cfg, ms=None, want_aux: bool = True):
    """The JAX package's single-group path (G = 1)."""
    E, topk = cfg.n_experts, cfg.moe_top_k
    probs, topw, topi = _route(x, params["router"], topk)
    cap = _capacity(x.shape[0], topk, E, cfg.capacity_factor)
    xe, (se, pos, tok, keep, w_sorted), _ = _dispatch(x, topw, topi, E, cap)
    y = _combine(_experts(xe, params), se, pos, w_sorted * keep, tok,
                 x.shape[0], topk)
    return y, (_aux_loss(probs, topi, E) if want_aux else None)


def _moe_block_global(x, params, cfg, ms):
    """The single-group path over the global tokens for a rank holding a
    part of them: the parts gathered over the data axes (differentiably),
    the whole routed on every rank, this rank's rows kept."""
    n, i = _share(ms)
    if n == 1:
        return _moe_block_gspmd(x, params, cfg)
    axes = ms.data_axes if ms.batch_axes is None else ms.batch_axes
    whole = col.gather_over(x, ms.group(axes), n, i)
    out, aux = _moe_block_gspmd(whole, params, cfg)
    T = x.shape[0]
    return out[i * T:(i + 1) * T], aux


# ===========================================================================
# Explicit expert parallelism — the multi-device path
# ===========================================================================

def _ep_group(xl, params, cfg, ms, m: int, e_loc: int):
    """One data shard's tokens through this model rank's experts: the
    routing redundant on every model rank, the rank's slab of experts, its
    partial output summed over the model axis (the "push")."""
    msz = ms.model_size
    mg = ms.model_group if msz > 1 else None
    xe, aux, (se, pos, tok, keep, w_sorted, C) = _local_dispatch(
        xl, params["router"], cfg)
    # xe, the gate weights and the expert weights are the same on every
    # model rank and each rank uses its slab: their cotangents add up
    # over the model axis
    lo, hi = m * e_loc, (m + 1) * e_loc
    xe = col.grad_sum_over(xe, mg, msz)[lo:hi]
    w_sorted = col.grad_sum_over(w_sorted, mg, msz)
    slab = {k: col.grad_sum_over(params[k], mg, msz)[lo:hi]
            for k in ("wi", "wg", "wo")}
    y = _experts(xe, slab)                                    # (e_loc, C, D)
    own = (se >= lo) & (se < hi) & keep
    partial = _combine(y, torch.clamp(se - lo, 0, e_loc - 1), pos,
                       w_sorted * own, tok, xl.shape[0], cfg.moe_top_k)
    return col.sum_over(partial, mg, msz), aux


def moe_block_ep(x, params, cfg, ms):
    """Expert parallelism (the JAX package's ``shard_map`` form).

    ``x``: this rank's part of the tokens (``ms.batch_axes``; by default
    its data shard); ``params``: the layer's moe weights whole, as the mesh
    step's pull leaves them (the all-gather of each rank's expert slab
    over the data axes is that pull).  Every model rank routes its data
    shard's tokens redundantly and takes its own slab of E / tp experts
    (dispatch needs no collective); the partial outputs are summed over
    the model axis (``psum`` -> all-reduce) and aux is averaged over the
    data axes (``pmean`` -> all-reduce / dp).  A rank holding several data
    shards' tokens (the batch did not divide) routes each shard as its own
    group.  E % tp != 0 falls back to the single-group path."""
    E = cfg.n_experts
    msz = ms.model_size
    e_loc = E // msz if E % msz == 0 else 0
    if e_loc == 0:
        DISPATCH["experts"] += 1
        return _moe_block_global(x, params, cfg, ms)
    DISPATCH["ep"] += 1
    m = ms.coord[ms.model_axis]
    n = _share(ms)[0]
    groups = ms.data_size // n              # data shards this rank holds
    Tg = x.shape[0] // groups
    outs, auxs = zip(*(_ep_group(x[j * Tg:(j + 1) * Tg], params, cfg, ms,
                                 m, e_loc) for j in range(groups)))
    out = outs[0] if groups == 1 else torch.cat(outs)
    aux = auxs[0] if groups == 1 else torch.stack(auxs).mean()
    dp = ms.data_size
    return out, col.mean_over(aux, ms.data_group if dp > 1 else None, dp)
