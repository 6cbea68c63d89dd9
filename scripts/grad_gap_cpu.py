#!/usr/bin/env python3
"""The training gradients of the port against the JAX package on the CPU
(ROADMAP C11): reduced starcoder2-3b, 4 seeds x 3 batch shapes, the loss
gap and each gradient leaf's largest difference relative to the leaf's
largest |value|; prints the worst leaves.

    PYTHONPATH=src:tests python scripts/grad_gap_cpu.py

Needs both packages (JAX on the CPU and the port); it measures rounding
differences between XLA and PyTorch, no device time."""
import jax
import numpy as np

from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JModelKnobs
from repro_torch.core.tree import flatten
from repro_torch.models.lm import ModelKnobs

from _torch_port import dense_models
from test_torch_train_step import _batch, _leaves_np, _port_grads, _tree_np

SHAPES = ((4, 16), (2, 32), (8, 8))


def main():
    worst, loss_gap = {}, 0.0
    for seed in range(4):
        cfg, tcfg, jp, tp = dense_models(seed)
        for B, S in SHAPES:
            jb, tb = _batch(seed, B, S)
            (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
                jp, jb, cfg, None, JModelKnobs())
            tl, tg = _port_grads(tp, tcfg, tb, ModelKnobs())
            loss_gap = max(loss_gap, abs(float(jl) - float(tl.detach())))
            jg = _tree_np(jg)
            for p, a, b in zip(flatten(jg)[0], _leaves_np(jg),
                               _leaves_np(tg)):
                rel = float(np.abs(a - b).max()) / float(np.abs(a).max())
                worst[p] = max(worst.get(p, 0.0), rel)
    print(f"loss gap {loss_gap:.3g} over 4 seeds x {len(SHAPES)} batch "
          f"shapes {SHAPES}")
    for p, r in sorted(worst.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {p}: {100 * r:.2f}% of the leaf's "
              f"largest |value|")


if __name__ == "__main__":
    main()
