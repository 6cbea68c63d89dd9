"""Deterministic synthetic batches (the JAX package's
``data/synthetic.py``): ``lm_batch_iterator``; for one (arch, shape)
cell, ``input_specs`` and ``synthetic_batch`` (the vlm's patches beside
the tokens, the encoder's frames in their place); and the paper-workload
datasets, ``regression_dataset`` (LogR / SVM) and ``image_dataset`` (CNN).

The values come from the same numpy generator calls in the same order, so
for a seed they equal the JAX package's exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm


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
    frontend_dim) bf16; for the encoder's frame frontend, ``frontend``
    frames (B, S, frontend_dim) bf16 (and ``labels`` (B, S) in training)
    and no tokens.  The decode kind: one new token against a cache of S
    positions, ``tokens`` (B, 1) int64, ``pos`` (B,) int32 and ``cache``
    {name: (shape, dtype)} of ``lm.init_cache_shapes`` in
    ``lm.cache_dtype``'s dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(f"input_specs kind {shape.kind!r}: train | "
                         f"prefill | decode")
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int64), "pos": ((B,), torch.int32),
                "cache": {k: (s, lm.cache_dtype(k)) for k, s in
                          lm.init_cache_shapes(cfg, B, S).items()}}
    if cfg.frontend == "frame":             # the whole sequence is frames
        batch = {"frontend": ((B, S, cfg.frontend_dim), torch.bfloat16)}
        if shape.kind == "train":
            batch["labels"] = ((B, S), torch.int64)
        return batch
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
    integers uniform over the vocabulary, patches and frames standard
    normal drawn in f32 and rounded to bf16, drawn in the order of the
    sorted names (the JAX package's tree order), so the values equal its
    batch's.  The decode kind's cache is zeros and ``pos`` is S - 1, as
    the JAX package sets them after drawing them: its normals for every
    cache leaf and its integers for ``pos`` are drawn and dropped first,
    so ``tokens`` comes from the same place in the stream."""
    specs = input_specs(cfg, shape)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}

    def draw_int(dims):
        return rng.integers(0, max(2, min(cfg.vocab_size, 1 << 30)), dims)

    for name in sorted(specs):
        if name == "cache":
            out[name] = {}
            for k in sorted(specs[name]):
                dims, dtype = specs[name][k]
                rng.standard_normal(dims)             # drawn, then dropped
                out[name][k] = torch.zeros(dims, dtype=dtype, device=dev)
            continue
        dims, dtype = specs[name]
        if name == "pos":
            draw_int(dims)
            out[name] = torch.full(dims, shape.seq_len - 1, dtype=dtype,
                                   device=dev)
        elif dtype == torch.int64:
            a = draw_int(dims)
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


def regression_dataset(n: int = 4096, d: int = 64, seed: int = 0,
                       task: str = "logreg", noise: float = 0.3,
                       cond: float = 1.0, device=None):
    """Synthetic convex workloads matching the paper's LogR / SVM jobs:
    (X (n, d) f32, y (n,) f32) on ``device`` (default: the CUDA device;
    raises without one unless ``device`` is given); y in {0, 1} for
    ``logreg``, else +-1.

    ``cond`` > 1 gives the features a geometric spectrum (ill-conditioning),
    which is what makes GD genuinely *long-running* as in the paper's jobs.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d) / np.sqrt(d)
    X = rng.standard_normal((n, d)).astype(np.float32)
    if cond > 1.0:
        scales = (1.0 / cond) ** (np.arange(d) / max(d - 1, 1))
        X = (X * scales[None, :]).astype(np.float32)
        w_true = w_true / scales
    margin = X @ w_true + noise * rng.standard_normal(n)
    y = (margin > 0).astype(np.float32) * 2.0 - 1.0          # +-1 labels
    if task == "logreg":
        y = (y + 1.0) / 2.0                                   # {0,1}
    return (torch.from_numpy(X).to(dev),
            torch.from_numpy(y.astype(np.float32)).to(dev))


def image_dataset(n: int = 2048, hw: int = 16, n_classes: int = 10,
                  seed: int = 0, noise: float = 0.8, device=None):
    """Tiny synthetic image classification set (the paper's CNN analogue):
    (images (n, hw, hw, 3) f32, labels (n,) int64) on ``device`` (default:
    the CUDA device; raises without one unless ``device`` is given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_classes, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n)
    imgs = protos[labels] + noise * rng.standard_normal(
        (n, hw, hw, 3)).astype(np.float32)
    return (torch.from_numpy(imgs).to(dev),
            torch.from_numpy(labels.astype(np.int64)).to(dev))
