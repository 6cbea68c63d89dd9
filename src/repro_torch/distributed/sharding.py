"""Mesh axes, partition rules and the placement of tensors on a mesh (the
JAX package's ``distributed/sharding.py``).

Mesh layout follows the PS mapping:
  * ``model`` axis  — the "servers": parameter/optimizer shards (TP/EP).
  * ``data`` axis   — the "workers": data-parallel replicas (+ FSDP shard).
  * ``pod`` axis    — optional outer data axis for multi-pod meshes.

Rules are path-based; every rule names the *unstacked* spec and is
automatically lifted over the leading layer-stack dimension.  Any dim that
is not divisible by its assigned axis group degrades gracefully (that axis
is dropped for that dim), so unusual widths (e.g. hubert's vocab of 504)
still shard everything else.

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names (the dimension split over several axes, the first outermost), or
None — the values of JAX's ``PartitionSpec``.

The port is multi-controller: one process a device.  A ``MeshSpec`` over
a live ``DeviceMesh`` knows the rank's coordinate and the process group
of each axis; over an ``AbstractMesh`` (JAX's shape-only mesh) it knows
the sizes only, which is all the spec functions read.  A rank holds only
its shard of each leaf: ``shard`` takes it from the whole tensor (a view),
``gather`` all-gathers it back over the axes its spec names.  Ranks are
laid out row-major over the axes, as JAX's ``make_mesh`` lays devices.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.tree import flatten, tree_map, unflatten


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices or process groups."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def _mesh_shape(mesh) -> dict:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    # DeviceMesh.shape, not .mesh.shape: .mesh rebuilds the rank tensor
    # on every read (0.26 ms), and the moe block reads the shape per call
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class MeshSpec:
    """``mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` (live) or
    an ``AbstractMesh`` (shape only).

    ``batch_axes`` says how a rank's activations lie over the data axes:
    None (the default) when the batch is split over every data axis, so
    each rank computes its own shard; otherwise the axes it is split over
    (``()`` when the batch did not divide and every rank holds it whole).
    The train step sets it for the forward; nothing of the placement of
    the state depends on it."""
    mesh: Any
    data_axes: tuple[str, ...]  # ("data",) or ("pod", "data")
    model_axis: str = "model"
    batch_axes: tuple[str, ...] | None = field(default=None, compare=False)
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return _mesh_shape(self.mesh)

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    @property
    def model_size(self) -> int:
        return int(self.shape[self.model_axis])

    @property
    def n_devices(self) -> int:
        return self.data_size * self.model_size

    @property
    def live(self) -> bool:
        return not isinstance(self.mesh, AbstractMesh)

    # -- symbols used in rules: "D" -> data axes, "M" -> model axis ---------
    def resolve(self, sym) -> Any:
        if sym == "D":
            return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
        if sym == "M":
            return self.model_axis
        return sym

    def axis_size(self, sym) -> int:
        if sym == "D":
            return self.data_size
        if sym == "M":
            return self.model_size
        return 1

    # -- the rank's place in a live mesh ------------------------------------
    @property
    def coord(self) -> dict | None:
        """This rank's index along each axis; None when the rank is not in
        the mesh.  A shape-only mesh of one device is its rank 0."""
        if not self.live:
            if self.n_devices == 1:
                return dict.fromkeys(self.shape, 0)
            raise ValueError("a shape-only mesh has no rank coordinates")
        c = self.mesh.get_coordinate()
        return None if c is None else dict(zip(self.mesh.mesh_dim_names, c))

    def size_of(self, entry) -> int:
        """The number of shards of a spec entry (1 for None)."""
        if entry is None:
            return 1
        return math.prod(self.shape[a] for a in _axes(entry))

    def index_of(self, entry) -> int:
        """This rank's shard index along a spec entry (row-major over its
        axes, the first outermost)."""
        if entry is None:
            return 0
        c = self.coord
        if c is None:
            raise ValueError("this rank is not in the mesh")
        i = 0
        for a in _axes(entry):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group of this rank's peers along ``axes`` (a name or
        a tuple of names)."""
        axes = _axes(axes)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        return self.groups[axes]

    @property
    def data_group(self):
        return self.group(self.data_axes)

    @property
    def model_group(self):
        return self.group(self.model_axis)


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def single_device_meshspec() -> MeshSpec:
    """A (1, 1) shape-only mesh: one device, every spec replicated."""
    return MeshSpec(mesh=AbstractMesh((1, 1), ("data", "model")),
                    data_axes=("data",))


# ---------------------------------------------------------------------------
# Parameter partition rules.  (regex on pytree path, unstacked spec symbols)
# ---------------------------------------------------------------------------
PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    (r"embed/tokens$",            ("M", "D")),
    (r"frontend/proj$",           (None, "D")),
    (r"lm_head/w$",               ("D", "M")),
    (r"(final_norm|ln1|ln2|ln3|norm)/scale$", (None,)),
    (r"attn/wq$",                 ("D", "M")),
    (r"attn/w[kv]$",              ("D", "M")),
    (r"attn/wo$",                 ("M", "D")),
    (r"attn/b[qkv]$",             ("M",)),
    (r"mlp/w[ig]$",               ("D", "M")),
    (r"mlp/wo$",                  ("M", "D")),
    (r"moe/router$",              ("D", None)),
    (r"moe/w[ig]$",               ("M", "D", None)),
    (r"moe/wo$",                  ("M", None, "D")),
    (r"ssm/in_proj$",             ("D", "M")),
    (r"ssm/conv_w$",              ("M", None)),
    (r"ssm/conv_b$",              ("M",)),
    (r"ssm/x_proj$",              ("M", None)),
    (r"ssm/dt_w$",                (None, "M")),
    (r"ssm/dt_b$",                ("M",)),
    (r"ssm/A_log$",               ("M", None)),   # mamba1 (Di,N)
    (r"ssm/A_log2$",              (None,)),       # mamba2 (nh,)
    (r"ssm/Dskip$",               ("M",)),
    (r"ssm/Dskip2$",              (None,)),
    (r"ssm/BC_proj$",             ("D", None)),
    (r"ssm/dt_proj2$",            ("D", None)),
    (r"ssm/dt_bias2$",            (None,)),
    (r"ssm/gnorm$",               ("M",)),
    (r"ssm/out_proj$",            ("M", "D")),
)


def shape_of(leaf) -> tuple:
    """A leaf's shape: a tensor's (or anything with ``.shape``), the shape
    of a ``(shape, dtype)`` pair (``train_state_shapes``), or a shape."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if len(leaf) == 2 and isinstance(leaf[0], tuple):
        return leaf[0]
    return tuple(leaf)


def _fit(spec_syms: tuple, shape: tuple, ms: MeshSpec) -> tuple:
    """Lift an unstacked rule over optional leading stack dims and drop axes
    that don't divide the corresponding dim."""
    pad = len(shape) - len(spec_syms)
    syms = (None,) * pad + tuple(spec_syms)
    out = []
    for dim, sym in zip(shape, syms):
        if sym is None:
            out.append(None)
            continue
        size = ms.axis_size(sym)
        if size > 1 and dim % size == 0:
            out.append(ms.resolve(sym))
        elif sym == "D" and len(ms.data_axes) > 1 and dim % ms.shape[ms.data_axes[-1]] == 0:
            out.append(ms.data_axes[-1])  # fall back to inner data axis only
        else:
            out.append(None)
    return tuple(out)


def param_pspec(path: str, shape, ms: MeshSpec) -> tuple:
    for pat, spec in PARAM_RULES:
        if re.search(pat, path):
            return _fit(spec, tuple(shape), ms)
    return (None,) * len(shape)


def param_specs(shapes_tree, ms: MeshSpec):
    """Tree of specs matching a tree of tensors or shapes."""
    paths, lv = flatten(shapes_tree)
    return unflatten(paths, [param_pspec(p, shape_of(x), ms)
                             for p, x in zip(paths, lv)])


@dataclass(frozen=True)
class Placement:
    """Where a leaf lies: its spec on a mesh (JAX's ``NamedSharding``)."""
    spec: tuple
    ms: MeshSpec


def param_shardings(shapes_tree, ms: MeshSpec):
    """Tree of ``Placement``s matching a tree of tensors or shapes: each
    leaf's ``param_specs`` entry on ``ms``."""
    return tree_map(lambda spec: Placement(spec, ms),
                    param_specs(shapes_tree, ms))


# ---------------------------------------------------------------------------
# Activation sharding helpers
# ---------------------------------------------------------------------------

def fit_act_spec(shape: tuple, syms: tuple, ms: MeshSpec) -> tuple:
    return _fit(syms, tuple(shape), ms)


def constrain(x, ms: MeshSpec | None, *syms):
    """JAX's ``with_sharding_constraint`` with the same divisibility
    fallback, for an activation ``x`` this rank holds: an identity at one
    device; under a mesh it checks that the spec's axes are the mesh's
    and moves no data (each rank already holds its part)."""
    if ms is None or ms.n_devices == 1:
        return x
    spec = _fit(tuple(syms), x.shape, ms)
    for e in spec:
        if e is not None and not set(_axes(e)) <= set(ms.shape):
            raise ValueError(f"spec {spec} names an axis outside {ms.shape}")
    return x


def batch_pspec(ms: MeshSpec, ndim: int, batch_dim: int = 0) -> tuple:
    out = [None] * ndim
    out[batch_dim] = ms.resolve("D")
    return tuple(out)


# ---------------------------------------------------------------------------
# Placement: a rank's shard of a whole tensor, and back
# ---------------------------------------------------------------------------

def shard(x: torch.Tensor, spec: tuple, ms: MeshSpec) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec``: a view
    (``x`` itself where every entry's axes have size 1)."""
    for dim, e in enumerate(spec):
        n = ms.size_of(e)
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, ms.index_of(e) * step, step)
    return x


def gather(x: torch.Tensor, spec: tuple, ms: MeshSpec) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x``: an all-gather over
    the axes of each sharded dimension (``x`` itself where none has more
    than one shard).  Every rank of those groups calls it."""
    import torch.distributed as dist
    for dim, e in enumerate(spec):
        n = ms.size_of(e)
        if n > 1:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=ms.group(e))
            x = torch.cat(parts, dim)
    return x


def is_whole(spec: tuple, ms: MeshSpec) -> bool:
    return all(ms.size_of(e) == 1 for e in spec)


def gather_tree(tree, specs, ms: MeshSpec):
    return tree_map(lambda x, s: gather(x, s, ms), tree, specs)
