"""Adam, SGD and momentum over nested-dict parameter trees (the JAX
package's ``optim/optimizers.py``).

The arithmetic is the reference's: f32 math on f32 copies of each
parameter, gradient and moment, cast back to the stored dtypes, with the
parameters kept in bf16 and no master copy.  What differs is where the
results go: the reference returns new trees, the port writes every
parameter and moment **in place**, leaf by leaf, in slices of at most
``SLICE`` values, so that at full width (4.31 B parameters) the update
needs neither a second copy of the state nor f32 temporaries the size of
the largest leaf (1.13 B values, 4.5 GB each), only a few of a slice's.
``count`` is a 0-dim int32 tensor on the device and the bias corrections
are computed there, so no step reads the device from the host.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import leaves, tree_map

SLICE = 1 << 26          # values a slice: 256 MB a f32 temporary


def _zeros_like(params, dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def _count(params):
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _slices(*tensors):
    """Matching flat slices of same-sized tensors, SLICE values at a
    time."""
    flats = [t.view(-1) for t in tensors]
    n = flats[0].numel()
    for lo in range(0, n, SLICE):
        yield [f[lo:lo + SLICE] for f in flats]


def adam_init(params, opt_dtype=torch.float32):
    return {"m": _zeros_like(params, opt_dtype),
            "v": _zeros_like(params, opt_dtype), "count": _count(params)}


@torch.no_grad()
def adam_update(params, grads, opt, tc: TrainConfig):
    """Adam with bias correction; ``params``, ``opt["m"]``, ``opt["v"]``
    and ``opt["count"]`` are updated in place.  Returns (params, opt)."""
    opt["count"] += 1
    b1, b2 = tc.beta1, tc.beta2
    cf = opt["count"].float()
    bc1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt["m"]),
                          leaves(opt["v"])):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            g32 = gs.float()
            m_new = b1 * ms.float() + (1 - b1) * g32
            v_new = b2 * vs.float() + (1 - b2) * torch.square(g32)
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + tc.eps)
            if tc.weight_decay:
                step = step + tc.weight_decay * ps.float()
            ps.copy_(ps.float() - tc.learning_rate * step)
            ms.copy_(m_new)
            vs.copy_(v_new)
    return params, opt


def sgd_init(params, opt_dtype=torch.float32, momentum: bool = True):
    st = {"count": _count(params)}
    if momentum:
        st["mu"] = _zeros_like(params, opt_dtype)
    return st


@torch.no_grad()
def sgd_update(params, grads, opt, tc: TrainConfig):
    """SGD, with heavy-ball momentum 0.9 when ``opt`` has ``mu``; in
    place, as ``adam_update``."""
    opt["count"] += 1
    mus = leaves(opt["mu"]) if "mu" in opt else None
    for i, (p, g) in enumerate(zip(leaves(params), leaves(grads))):
        if mus is None:
            for ps, gs in _slices(p, g):
                ps.copy_(ps.float() - tc.learning_rate * gs.float())
            continue
        for ps, gs, mus_ in _slices(p, g, mus[i]):
            mu_new = 0.9 * mus_.float() + gs.float()
            ps.copy_(ps.float() - tc.learning_rate * mu_new)
            mus_.copy_(mu_new)
    return params, opt


def make_optimizer(tc: TrainConfig, opt_dtype=torch.float32):
    """(init(params) -> opt, update(params, grads, opt) -> (params, opt))
    for ``tc.optimizer``: adam | momentum | sgd."""
    if tc.optimizer == "adam":
        return (lambda p: adam_init(p, opt_dtype),
                lambda p, g, o: adam_update(p, g, o, tc))
    if tc.optimizer == "momentum":
        return (lambda p: sgd_init(p, opt_dtype, True),
                lambda p, g, o: sgd_update(p, g, o, tc))
    return (lambda p: sgd_init(p, opt_dtype, False),
            lambda p, g, o: sgd_update(p, g, o, tc))


def opt_state_shapes(param_shapes_tree, tc: TrainConfig,
                     opt_dtype=torch.float32):
    """The optimizer state's (shape, dtype) leaves, without allocating."""
    def z(shape):
        return (tuple(shape), opt_dtype)
    count = ((), torch.int32)
    if tc.optimizer == "adam":
        return {"m": tree_map(z, param_shapes_tree),
                "v": tree_map(z, param_shapes_tree), "count": count}
    if tc.optimizer == "momentum":
        return {"mu": tree_map(z, param_shapes_tree), "count": count}
    return {"count": count}
