"""Deterministic synthetic LM batches (the JAX package's
``data/synthetic.py`` ``lm_batch_iterator``).

The tokens come from the same numpy generator calls in the same order, so
for a seed they equal the JAX package's exactly.  ``input_specs``,
``synthetic_batch`` and the paper-workload datasets (LogR / SVM / CNN) are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def lm_batch_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                      device=None):
    """Infinite deterministic LM batch stream with next-token labels:
    ``{"tokens", "labels"}``, (batch, seq) int64 on ``device`` (default:
    the CUDA device; raises without one unless ``device`` is given).

    A fixed successor map with 10% noise, so the loss can fall (the tokens
    are learnable, not iid noise).  On the card both arrays of a batch go
    through one pinned host buffer and one asynchronous copy; the buffer is
    rewritten only once the previous batch's copy has run."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    table = rng.integers(0, V, size=(V,))          # deterministic successor map
    pinned = copied = None
    if dev.type == "cuda":
        pinned = torch.empty((2, batch, seq), dtype=torch.int64,
                             pin_memory=True)
        copied = torch.cuda.Event()
    while True:
        start = rng.integers(0, V, size=(batch, 1))
        toks = [start]
        for _ in range(seq):
            nxt = table[toks[-1]]
            flip = rng.random((batch, 1)) < 0.1    # 10% noise
            rnd = rng.integers(0, V, size=(batch, 1))
            toks.append(np.where(flip, rnd, nxt))
        arr = np.concatenate(toks, axis=1)         # (B, seq+1)
        pair = np.stack([arr[:, :-1], arr[:, 1:]])
        if pinned is None:
            out = torch.from_numpy(pair.astype(np.int64)).to(dev)
        else:
            copied.synchronize()
            pinned.numpy()[...] = pair
            out = torch.empty(pinned.shape, dtype=torch.int64, device=dev)
            out.copy_(pinned, non_blocking=True)
            copied.record()
        yield {"tokens": out[0], "labels": out[1]}
