"""What one traced step moves and computes, and its roofline on the H100
(the port's counterpart of the JAX package's ``distributed/hlo_analysis.py``
and ``hlo_parse.py``, which read a compiled XLA executable; the port has
no HLO, so it counts from the step itself).

The dry run (``launch/dryrun.py``) runs one step of the port on meta
tensors of a rank's shards, under a fake process group of the mesh's
world, inside three ``TorchDispatchMode``s:

  ``LiveBytes``          the bytes of live tensor storage after every
                         operator, and their peak: the step's memory as
                         the caching allocator would hold it (rounding and
                         fragmentation aside);
  ``CollectiveCounter``  every ``c10d`` operator: per-device bytes by kind,
                         by the JAX package's convention (all-gather,
                         all-reduce, all-to-all and broadcast count result
                         bytes; reduce-scatter result bytes x group), and
                         the seconds each takes at its group's link rate;
  ``FlopCounterMode``    (PyTorch's) the matrix products' FLOPs, and the
                         attention kernels' through the formulas their
                         operators register (``kernels/_build.py``).

An eager trace runs every call, so no trip-count weighting is needed.

Peaks: the NVIDIA H100 SXM5 80GB spec sheet at 700 W, not measured: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 450 GB/s each way inside one
8-card node, and a card's 400 Gb/s NDR port (50 GB/s) for a group that
spans nodes (ranks laid row-major, 8 a node).
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM5 80GB, spec sheet at 700 W (not measured)
PEAK_FLOPS = 989e12                 # dense bf16 tensor cores
HBM_BW = 3.35e12                    # HBM3
NVLINK_BW = 450e9                   # each way, a group inside one node
NET_BW = 50e9                       # 400 Gb/s NDR a card, across nodes
CARDS_PER_NODE = 8
HBM_BYTES = 80e9                    # the card's memory, for ``fits``

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "broadcast")
_C10D = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "broadcast"}
# (each one's result is its first argument, written in place)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def group_ranks(func, args) -> list[int]:
    """The global ranks of the process group a ``c10d`` operator runs on
    (its ``ProcessGroup`` argument, found by its schema)."""
    import torch.distributed as dist
    for a, arg in zip(func._schema.arguments, args):
        if "ProcessGroup" in str(a.type):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(arg))
    raise ValueError(f"{func}: no process group argument")


def link_bw(ranks) -> float:
    """The link rate of a group: NVLink inside one node, else the card's
    network port."""
    nodes = {r // CARDS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else NET_BW


class CollectiveCounter(TorchDispatchMode):
    """Per-device bytes and calls of every collective by kind, and the
    seconds they take at their groups' link rates (``link_bw``)."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLL_KINDS, 0)
        self.counts = dict.fromkeys(COLL_KINDS, 0)
        self.seconds = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d" and name in _C10D:
            kind = _C10D[name]
            ranks = group_ranks(func, args)
            n = _nbytes(args[0])
            if kind == "reduce-scatter":
                n *= len(ranks)
            self.bytes[kind] += n
            self.counts[kind] += 1
            self.seconds += n / link_bw(ranks)
        return func(*args, **(kwargs or {}))

    def to_dict(self) -> dict:
        return dict(self.bytes, total=sum(self.bytes.values()),
                    counts=dict(self.counts), seconds=self.seconds)


class LiveBytes(TorchDispatchMode):
    """The bytes of the tensor storages created under this mode that are
    still alive, after every operator, and their peak.  A storage counts
    once (views share it) from the operator that made it until Python
    frees it."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def _gone(self, key: int):
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += self._seen[key]
            weakref.finalize(st, self._gone, key)
        self.peak = max(self.peak, self.live)
        return out


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_device: float
    useful_ratio: float          # model FLOPs / counted FLOPs
    roofline_fraction: float     # useful compute time / the largest term

    def to_dict(self):
        return asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float,
                   model_flops_per_device: float, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = NET_BW,
                   coll_seconds: float | None = None) -> Roofline:
    """The three terms of a step and the largest, as the JAX package's
    ``roofline_terms`` (which it equals given its peaks: ``peak_flops``,
    ``hbm_bw`` and ``link_bw`` its PEAK_FLOPS, HBM_BW and ICI_BW).
    ``coll_seconds``: the collective term reckoned group by group
    (``CollectiveCounter.seconds``) instead of all bytes at ``link_bw``."""
    ct = flops_per_device / peak_flops
    mt = bytes_per_device / hbm_bw
    xt = (coll_bytes_per_device / link_bw if coll_seconds is None
          else coll_seconds)
    terms = {"compute": ct, "memory": mt, "collective": xt}
    bottleneck = max(terms, key=terms.get)
    dominant = terms[bottleneck]
    model_ct = model_flops_per_device / peak_flops
    return Roofline(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        compute_s=ct, memory_s=mt, collective_s=xt,
        bottleneck=bottleneck,
        model_flops_per_device=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops_per_device
                      if flops_per_device else 0.0),
        roofline_fraction=model_ct / dominant if dominant > 0 else 0.0)


def memory_stats(live: LiveBytes, argument_bytes: int) -> dict:
    """A traced step's memory (the JAX package's ``memory_stats`` of a
    compiled step, from the trace's counts): what it is given (its state
    and inputs, ``argument_bytes``), what it adds at its peak
    (``temp_bytes``), what is live after it, and whether the peak fits
    the card."""
    return {"argument_bytes": int(argument_bytes),
            "temp_bytes": int(live.peak - argument_bytes),
            "end_bytes": int(live.live),
            "peak_estimate_bytes": int(live.peak),
            "hbm_bytes": int(HBM_BYTES),
            "fits": bool(live.peak <= HBM_BYTES)}
