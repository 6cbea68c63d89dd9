"""Collectives that autograd differentiates, for the parts of a step that
split work across ranks (expert parallelism, ``models/moe.py``).

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
                     cotangents and this rank's rows backward.

At a group of one rank each is the identity, with no collective.
"""
from __future__ import annotations

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
