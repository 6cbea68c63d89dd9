"""Deterministic synthetic batches (the JAX package's
``data/synthetic.py``): ``lm_batch_iterator`` and, for one (arch, shape)
cell, ``input_specs`` and ``synthetic_batch`` (the vlm's patches beside
the tokens).

The values come from the same numpy generator calls in the same order, so
for a seed they equal the JAX package's exactly.  ``synthetic_batch``'s
decode kind (JAX's dense per-slot cache, which the port does not keep) and
the paper-workload datasets (LogR / SVM / CNN) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions of a ``seq_len`` cell: the patch frontend takes
    ``frontend_len`` of them."""
    if cfg.frontend == "patch":
        return seq_len - cfg.frontend_len
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, torch dtype)} of one cell's model inputs, without
    allocating: ``tokens`` (and ``labels`` in training) int64 over the
    text positions, and the vlm's ``frontend`` patches (B, frontend_len,
    frontend_dim) bf16.  The frame frontend (the encoder family) and the
    decode kind are not ported yet."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "frame":
        raise NotImplementedError("the frame frontend (the encoder family) "
                                  "is not ported yet")
    if shape.kind not in ("train", "prefill"):
        raise NotImplementedError(
            f"input_specs kind {shape.kind!r}: the decode kind builds the "
            f"JAX package's dense per-slot cache and is not ported yet")
    T = _text_len(cfg, S)
    batch = {"tokens": ((B, T), torch.int64)}
    if shape.kind == "train":
        batch["labels"] = ((B, T), torch.int64)
    if cfg.frontend == "patch":
        batch["frontend"] = ((B, cfg.frontend_len, cfg.frontend_dim),
                             torch.bfloat16)
    return batch


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                    device=None) -> dict:
    """One real batch of ``input_specs``'s shapes on ``device`` (default:
    the CUDA device; raises without one unless ``device`` is given):
    integers uniform over the vocabulary, patches standard normal drawn
    in f32 and rounded to bf16, drawn in the order of the sorted names
    (the JAX package's tree order), so the values equal its batch's."""
    specs = input_specs(cfg, shape)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(specs):
        dims, dtype = specs[name]
        if dtype == torch.int64:
            a = rng.integers(0, max(2, min(cfg.vocab_size, 1 << 30)), dims)
            out[name] = torch.from_numpy(a.astype(np.int64)).to(dev)
        else:
            a = rng.standard_normal(dims).astype(np.float32)
            out[name] = torch.from_numpy(a).to(device=dev, dtype=dtype)
    return out


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
