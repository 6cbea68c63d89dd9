"""Nested-dict trees of tensors, flattened in sorted key order.

The JAX package's states are pytrees of dicts, and ``jax.tree_util``
flattens a dict by its sorted keys.  The port keeps its states as nested
dicts with the same keys and flattens them the same way, so leaf ``i`` is
the same leaf in both packages: the gradient compressor's per-leaf random
streams and the checkpoints' ``a<i>`` arrays depend on that order.
"""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> tuple[list[str], list]:
    """(paths, leaves) of a nested dict, keys sorted at every level;
    paths join keys with "/" as the JAX checkpoints name them."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths, leaves = [], []
    for k in sorted(tree):
        p, lv = flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        paths += p
        leaves += lv
    return paths, leaves


def leaves(tree) -> list:
    return flatten(tree)[1]


def unflatten(paths: list[str], values: list) -> dict:
    """The nested dict whose ``flatten`` gives ``paths`` and ``values``."""
    out: dict = {}
    for path, v in zip(paths, values):
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
