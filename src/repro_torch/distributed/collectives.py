"""Collectives that autograd differentiates, for the parts of a step that
split work across ranks: expert parallelism (``models/moe.py``), tensor
parallelism over ``model`` and the per-layer pull (``models/lm.py``).

The mesh step's convention: every rank computes the loss of its batch
shard, the ranks along ``model`` the same one, and the push averages the
gradients over the data axes.  So a value that the ranks of a group hold
alike carries the same cotangent on each of them.  The JAX package gets
these transposes from ``shard_map``; here each is written out:

  ``sum_over``       psum of partial values: all-reduce forward, the
                     cotangent passed through unchanged backward;
  ``grad_sum_over``  a value every rank of the group holds, used for a
                     partial result: identity forward, all-reduce of the
                     cotangents backward (Megatron's "f");
  ``mean_over``      pmean: all-reduce / n forward, the cotangent passed
                     through (the push's mean over data divides it);
  ``gather_over``    all-gather along dim 0 forward, all-reduce of the
                     cotangents and this rank's rows backward;
  ``to_model``       Megatron's f (``grad_sum_over`` over ``model``, the
                     cotangents summed in f32);
  ``from_model``     Megatron's g (``sum_over`` over ``model``, summed in
                     f32);
  ``gather_rows``    the sequence path's rows all-gathered over ``model``,
                     the rank's rows of the cotangent backward;
  ``gather_params``  the per-layer pull, a layer's leaves in buckets:
                     one all-gather forward, the push (one reduce-scatter,
                     or the rank's slice) backward, a step of a bucket
                     (``gather_param``: a bucket of one); and
                     ``keep_shards``, under which autograd saves a gathered
                     parameter as its bucket's shards.

At a group of one rank each is the identity, with no collective.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _reduced(x, group):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _reduced(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = _reduced(g, ctx.group)
        r = ctx.rows
        return g[ctx.index * r:(ctx.index + 1) * r], None, None, None


def sum_over(x, group, n: int):
    return x if n == 1 else _SumOver.apply(x, group)


def grad_sum_over(x, group, n: int):
    return x if n == 1 else _GradSumOver.apply(x, group)


def mean_over(x, group, n: int):
    return x if n == 1 else _MeanOver.apply(x, group, n)


def gather_over(x, group, n: int, index: int):
    return x if n == 1 else _GatherOver.apply(x, group, n, index)


# ---------------------------------------------------------------------------
# Tensor parallelism over ``model`` (Megatron's f and g), the sequence
# path's rows, and the per-layer pull
# ---------------------------------------------------------------------------

def _f32_sum(x, group):
    """``x`` all-reduced over ``group`` in f32 (a new tensor)."""
    s = x.to(torch.float32, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(s, group=group)
    return s


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype = x.dtype
        return _f32_sum(x, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _f32_sum(g, ctx.group).to(g.dtype), None


def to_model(x, group, n: int):
    """Megatron's f, placed after a norm that feeds a column-parallel
    product: identity forward; backward, the cotangents' all-reduce over
    ``model`` (each rank's product gives a partial one), summed in f32 and
    rounded once, as ``from_model`` sums."""
    return x if n == 1 else _ToModel.apply(x, group)


def from_model(x, group, n: int, dtype=None):
    """Megatron's g, after a row-parallel product: the partial results
    (f32 partial sums, ``lm.partial_product``, or partial values of any
    dtype) all-reduced over ``model`` in f32 and rounded once to ``dtype``
    (default x's); the cotangent, the same on every rank, passed through
    backward."""
    dtype = dtype or x.dtype
    if n == 1:
        return x.to(dtype)
    return _FromModel.apply(x, group, dtype)


def _all_gather_dim(x, group, n: int, dim: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.index, ctx.dim, ctx.rows = index, dim, x.shape[dim]
        return _all_gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        return g.narrow(ctx.dim, ctx.index * r, r), None, None, None, None


def gather_rows(x, group, n: int, index: int, dim: int = 1):
    """The sequence path's rows put back together: each rank's rows
    all-gathered along ``dim`` over ``model``; backward, the rank's rows
    of the cotangent, which every rank holds whole and alike (no
    exchange).  Its inverse, a rank taking its rows of a value every rank
    holds, is plain slicing under ``to_model``: the rows' cotangents of
    the ranks are summed by ``to_model``'s all-reduce."""
    return x if n == 1 else _GatherRows.apply(x, group, n, index, dim)


def _moved(shape, dim: int) -> tuple:
    return (shape[dim],) + tuple(shape[:dim]) + tuple(shape[dim + 1:])


def _unpacked(flat, shapes, dims, rows: int) -> list:
    """The leaves of a bucket from ``flat`` (rows, total): leaf i is
    columns [off, off + k_i) of every row, each row a part of it along
    dim ``dims[i]`` moved first; the rows stacked along that dim (a copy
    where there are several leaves), moved back (a view)."""
    out, off = [], 0
    for shape, d in zip(shapes, dims):
        k = math.prod(shape)
        m = _moved(shape, d)
        x = flat[:, off:off + k].reshape((rows * m[0],) + m[1:])
        out.append(x.movedim(0, d))
        off += k
    return out


def _gather_bucket(shards, steps) -> list:
    """The leaves of a bucket gathered along each of its ``steps`` =
    ((group, n, index, summed, dims), ...): one all-gather a step of the
    leaves' flat shards, leaf i along ``dims[i]``."""
    xs = list(shards)
    for group, n, _, _, dims in steps:
        flat = torch.cat([x.movedim(d, 0).reshape(-1)
                          for x, d in zip(xs, dims)])
        buf = flat.new_empty((n, flat.numel()))
        dist.all_gather(list(buf.unbind(0)), flat, group=group)
        xs = _unpacked(buf, [tuple(x.shape) for x in xs], dims, n)
    return xs


class _GatherBucket(torch.autograd.Function):
    """The pull of a bucket: its leaves gathered together, one all-gather
    a step; backward, their gradients pushed together, one reduce-scatter
    (or, not ``summed``, the rank's slice) a step, in reverse."""

    @staticmethod
    def forward(ctx, steps, *shards):
        ctx.steps = steps
        ctx.shapes = [[tuple(s.shape) for s in shards]]
        xs = list(shards)
        for step in steps:
            xs = _gather_bucket(xs, (step,))
            ctx.shapes.append([tuple(x.shape) for x in xs])
        return tuple(xs)

    @staticmethod
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        gs = [torch.zeros(shape, dtype=ref.dtype, device=ref.device)
              if g is None else g
              for g, shape in zip(grads, ctx.shapes[-1])]
        for i in reversed(range(len(ctx.steps))):
            group, n, index, summed, dims = ctx.steps[i]
            # rank r's part of every leaf's gradient in row r
            parts = torch.cat([g.movedim(d, 0).reshape(n, -1)
                               for g, d in zip(gs, dims)], dim=1)
            if summed:
                out = parts.new_empty(parts.shape[1])
                dist.reduce_scatter(out, list(parts.unbind(0)), group=group)
            else:
                out = parts[index]
            gs = [x.contiguous() for x in
                  _unpacked(out[None], ctx.shapes[i], dims, 1)]
        return (None, *gs)


class _Bucket:
    """A bucket's shards and steps, gathered again in the backward
    (``keep_shards.regathered``)."""

    def __init__(self, shards, steps):
        self.shards, self.steps = shards, steps


def gather_params(shards: list, steps: list) -> list:
    """The per-layer pull of several parameters: ``shards[i]``
    all-gathered along each of ``steps[i]`` = ((dim, group, n, index,
    summed), ...) in order (``shards[i]`` itself with no steps).  The
    leaves of one dtype whose steps name the same groups, ranks and kinds
    of push, in the same order (along any dims), are a bucket, gathered
    together: one all-gather a step forward, and backward, the push of
    their gradients, one collective a step in reverse: a reduce-scatter
    (``summed``: each rank's gradient is a partial one, as over the data
    axes, whose ranks hold different batch shards) or, where the ranks
    computed alike and hold the same gradient (a layer whose compute
    stays repeated over ``model``), the rank's slice of it with no
    exchange.

    Under ``keep_shards`` the gathered tensors are not what autograd keeps
    for the backward: a product that saves one saves the bucket's shards,
    and the backward gathers the bucket again."""
    out = list(shards)
    buckets: dict = {}
    for i, (x, st) in enumerate(zip(shards, steps)):
        if st:
            key = (x.dtype,) + tuple((id(group), n, index, summed)
                                     for _, group, n, index, summed in st)
            buckets.setdefault(key, []).append(i)
    for idx in buckets.values():
        first = steps[idx[0]]
        meta = tuple((group, n, index, summed,
                      tuple(steps[i][j][0] for i in idx))
                     for j, (_, group, n, index, summed) in enumerate(first))
        mine = [shards[i] for i in idx]
        wholes = _GatherBucket.apply(meta, *mine)
        if _SAVERS:
            bucket = _Bucket(mine, meta)
            for j, w in enumerate(wholes):
                _SAVERS[-1].register(w, bucket, j)
        for i, w in zip(idx, wholes):
            out[i] = w
    return out


def gather_param(shard, steps):
    """``gather_params`` of one parameter: a bucket of one leaf."""
    return gather_params([shard], [steps])[0]


_SAVERS: list = []


class keep_shards:
    """While active, a saved tensor that is (a view of) a tensor
    ``gather_params`` made is packed as its bucket and place, and unpacked
    by gathering the bucket again
    (``torch.autograd.graph.saved_tensors_hooks``): so the backward holds
    no more than one layer's gathered parameters, as the forward does.  A
    gathered tensor is known by its storage while it lives (a dead one's
    storage may be reused)."""

    def __init__(self):
        self._live: dict[int, tuple] = {}
        self._last = (None, None)

    def register(self, whole, bucket, j: int):
        """``whole`` is leaf ``j`` of ``bucket`` gathered."""
        import weakref
        key = whole.untyped_storage()._cdata
        self._live[key] = (bucket, j)
        weakref.finalize(whole, self._live.pop, key, None)

    def regathered(self, bucket) -> list:
        """``bucket``'s leaves gathered again: once for all of them (the
        last bucket gathered is kept until another is asked for, so the
        backward holds one layer's)."""
        if self._last[0] is not bucket:
            self._last = (None, None)
            with torch.no_grad():
                self._last = (bucket, _gather_bucket(bucket.shards,
                                                     bucket.steps))
        return self._last[1]

    def _pack(self, t):
        got = self._live.get(t.untyped_storage()._cdata) \
            if isinstance(t, torch.Tensor) else None
        if got is None:
            return t
        return (_Regather, self, *got, tuple(t.shape), t.stride(),
                t.storage_offset())

    @staticmethod
    def _unpack(h):
        if not (isinstance(h, tuple) and h and h[0] is _Regather):
            return h
        _, saver, bucket, j, size, stride, offset = h
        return saver.regathered(bucket)[j].as_strided(size, stride, offset)

    def __enter__(self):
        from torch.autograd.graph import saved_tensors_hooks
        self._hooks = saved_tensors_hooks(self._pack, self._unpack)
        self._hooks.__enter__()
        _SAVERS.append(self)
        return self

    def __exit__(self, *exc):
        _SAVERS.pop()
        self._hooks.__exit__(*exc)
        self._live.clear()
        self._last = (None, None)


class _Regather:
    """Marks a packed gathered parameter (``keep_shards``)."""
