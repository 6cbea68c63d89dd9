#!/usr/bin/env python3
"""The training gradients of the port against the JAX package on the CPU
(ROADMAP C11): a reduced model, 4 seeds x 3 batch shapes, the loss gap and
each gradient leaf's largest difference relative to the leaf's largest
|value|; prints the worst leaves.

    PYTHONPATH=src:tests python scripts/grad_gap_cpu.py
    PYTHONPATH=src:tests python scripts/grad_gap_cpu.py --family ssm
    PYTHONPATH=src:tests python scripts/grad_gap_cpu.py --family hybrid \\
        --layers 1 --noise

``--family`` picks reduced starcoder2-3b (dense), falcon-mamba-7b (ssm) or
zamba2-1.2b (hybrid, ``--layers`` deep: the shared block after layers 0,
2, ...).  ``--noise`` also prints the port's own rounding-noise floor: its
gradients against themselves with every attention output (or, for the ssm
family, every RMSNorm input) moved by one bf16 step, how far one rounding
moves them.  Needs both packages (JAX on the CPU and the port);
it measures rounding differences between XLA and PyTorch, no device
time."""
import argparse

import jax
import numpy as np
import torch

from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JModelKnobs
from repro_torch.core.tree import flatten
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs

from _torch_port import dense_models, hybrid_models, ssm_models
from test_torch_train_step import _batch, _leaves_np, _port_grads, _tree_np

SHAPES = ((4, 16), (2, 32), (8, 8))


def _models(family, seed, layers):
    if family == "hybrid":
        return hybrid_models(seed, n_layers=layers)
    return (ssm_models if family == "ssm" else dense_models)(seed)


def _step_up(x):
    """x (bf16) with each value moved one bf16 step away from zero."""
    return (x.float() * (1 + 2.0 ** -7)).to(x.dtype)


def _one_step_up(fn):
    """``fn`` with its first argument moved up by one bf16 step."""
    return lambda x, *a, **kw: fn(_step_up(x), *a, **kw)


def _output_step_up(fn):
    """``fn`` with its output moved up by one bf16 step."""
    return lambda *a, **kw: _step_up(fn(*a, **kw))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="dense",
                    choices=("dense", "ssm", "hybrid"))
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--noise", action="store_true")
    args = ap.parse_args()
    worst, noise, loss_gap = {}, {}, 0.0
    for seed in range(4):
        cfg, tcfg, jp, tp = _models(args.family, seed, args.layers)
        for B, S in SHAPES:
            jb, tb = _batch(seed, B, S)
            (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
                jp, jb, cfg, None, JModelKnobs())
            tl, tg = _port_grads(tp, tcfg, tb, ModelKnobs())
            loss_gap = max(loss_gap, abs(float(jl) - float(tl.detach())))
            jg = _tree_np(jg)
            paths = flatten(jg)[0]
            for p, a, b in zip(paths, _leaves_np(jg), _leaves_np(tg)):
                rel = float(np.abs(a - b).max()) / float(np.abs(a).max())
                worst[p] = max(worst.get(p, 0.0), rel)
            if not args.noise:
                continue
            mod = lm if args.family != "ssm" else lm.common
            name = "chunked_attention" if args.family != "ssm" else "rms_norm"
            real = getattr(mod, name)
            setattr(mod, name, _one_step_up(real) if name == "rms_norm"
                    else _output_step_up(real))
            try:
                _, ng = _port_grads(tp, tcfg, tb, ModelKnobs())
            finally:
                setattr(mod, name, real)
            for p, a, b in zip(paths, _leaves_np(tg), _leaves_np(ng)):
                rel = float(np.abs(a - b).max()) / float(np.abs(a).max())
                noise[p] = max(noise.get(p, 0.0), rel)
    print(f"{args.family} ({cfg.n_layers} layers): loss gap {loss_gap:.3g} "
          f"over 4 seeds x {len(SHAPES)} batch shapes {SHAPES}")
    for p, r in sorted(worst.items(), key=lambda kv: -kv[1])[:6]:
        extra = (f" (the port's one-step noise floor there "
                 f"{100 * noise[p]:.2f}%)" if args.noise else "")
        print(f"  {p}: {100 * r:.2f}% of the leaf's largest |value|{extra}")
    if args.noise:
        p, r = max(noise.items(), key=lambda kv: kv[1])
        print(f"  noise floor: worst leaf {p} {100 * r:.2f}%")


if __name__ == "__main__":
    main()
