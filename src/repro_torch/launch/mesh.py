"""Process groups and meshes (the JAX package's ``launch/mesh.py``).

The port runs one process a device.  ``init_distributed`` starts the
process group from ``torchrun``'s environment (or a given store): NCCL for
the card, gloo for the CPU, following the device the caller asked for,
with no fallback from one to the other.  ``make_meshspec(dp, tp)`` lays a
(data, model) ``DeviceMesh`` over the first dp * tp ranks, row-major, as
the JAX package reshapes ``jax.devices()[:n]``.

``make_production_mesh`` and ``production_meshspec`` build the
production meshes, 16x16 = 256 devices ("data" x "model") or 2 x 16 x 16 =
512 with a leading "pod" axis, in their shape-only form (the specs of a
production run can be computed anywhere); ``live=True`` lays them over
the process group and raises when the world is smaller.  Importing this
module touches no device and no process group.
"""
from __future__ import annotations

import os

import torch

from repro_torch.distributed.sharding import AbstractMesh, MeshSpec

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) when no process group is up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def launched() -> bool:
    """True under ``torchrun`` (its environment names the world)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device, init_method: str = "env://", rank=None,
                     world_size=None, timeout=None):
    """Start the default process group for ``device`` (a torch device or
    its name): NCCL for ``cuda``, gloo for ``cpu``.  ``init_method`` is
    ``env://`` (torchrun's environment), a ``file://`` store or a
    ``tcp://localhost:<port>`` address; ``rank`` and ``world_size`` default
    to the environment's; ``timeout`` (a ``timedelta``) bounds each
    collective.  On the card each rank takes device ``LOCAL_RANK``
    (default: its rank).  Returns (rank, world size)."""
    import torch.distributed as dist
    device = torch.device(device)
    backend = _BACKENDS[device.type]
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return rank, world_size


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _meshspec_over(shape: tuple, names: tuple, data_axes: tuple) -> MeshSpec:
    """A live MeshSpec over the first prod(shape) ranks.  Every rank of the
    world calls it (the groups are made collectively); a rank past the
    mesh gets a MeshSpec whose ``coord`` is None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    _, size = world()
    if not dist.is_initialized() or size < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the world has {size}")
    ranks = torch.arange(n).reshape(shape)
    mesh = DeviceMesh(_device_type(), ranks, mesh_dim_names=names)
    groups = {}
    if len(data_axes) > 1:
        # one group a model index: the ranks of every data axis together,
        # in sorted (row-major) order, so group rank = data index
        flat = ranks.reshape(-1, shape[-1])
        for j in range(shape[-1]):
            members = flat[:, j].tolist()
            g = dist.new_group(members)
            if dist.get_rank() in members:
                groups[data_axes] = g
    return MeshSpec(mesh=mesh, data_axes=data_axes, groups=groups)


def make_meshspec(dp: int, tp: int) -> MeshSpec:
    """A (dp, tp) mesh over the live process group (its first dp * tp
    ranks); raises when the world is smaller."""
    return _meshspec_over((dp, tp), ("data", "model"), ("data",))


def make_production_mesh(*, multi_pod: bool = False, live: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if live:
        return _meshspec_over(shape, axes, axes[:-1]).mesh
    return AbstractMesh(shape, axes)


def production_meshspec(*, multi_pod: bool = False,
                        live: bool = False) -> MeshSpec:
    data_axes = ("pod", "data") if multi_pod else ("data",)
    if live:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        return _meshspec_over(shape, data_axes + ("model",), data_axes)
    return MeshSpec(mesh=make_production_mesh(multi_pod=multi_pod),
                    data_axes=data_axes)
