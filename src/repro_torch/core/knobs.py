"""System-setting (knob) space — paper §III.

A *system setting* ``X = <c_1=v_1, ..., c_d=v_d>`` changes only efficiency,
never the learning problem (the paper's system-parameter vs hyperparameter
distinction). Ordinal knobs are scaled to [0,1]; nominal knobs are one-hot
encoded (paper §III-D).
"""
from __future__ import annotations

import itertools
import random as _random
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str                  # "ordinal" | "nominal" | "bool" | "continuous"
    values: tuple              # discrete admissible values, in order;
                               # for "continuous": (lo, hi) float range

    def encode(self, v) -> list[float]:
        if self.kind == "nominal":
            out = [0.0] * len(self.values)
            out[self.values.index(v)] = 1.0
            return out
        if self.kind == "bool":
            return [1.0 if v else 0.0]
        if self.kind == "continuous":
            lo, hi = self.values
            return [(float(v) - lo) / max(hi - lo, 1e-12)]
        idx = self.values.index(v)
        if len(self.values) == 1:
            return [0.0]
        return [idx / (len(self.values) - 1)]

    def dim(self) -> int:
        return len(self.values) if self.kind == "nominal" else 1

    def clip(self, v):
        if self.kind != "continuous":
            return v
        lo, hi = self.values
        return min(hi, max(lo, float(v)))


@dataclass(frozen=True)
class KnobSpace:
    knobs: tuple[Knob, ...]

    def names(self):
        return [k.name for k in self.knobs]

    def encode(self, setting: dict) -> list[float]:
        out: list[float] = []
        for k in self.knobs:
            out.extend(k.encode(setting[k.name]))
        return out

    def dim(self) -> int:
        return sum(k.dim() for k in self.knobs)

    def sample(self, rng: _random.Random) -> dict:
        out = {}
        for k in self.knobs:
            if k.kind == "continuous":
                lo, hi = k.values
                out[k.name] = rng.uniform(lo, hi)
            else:
                out[k.name] = rng.choice(k.values)
        return out

    def stratified_samples(self, rng: _random.Random, n: int) -> list[dict]:
        """Latin-hypercube-style initialization pool: ``n`` settings that
        jointly cover each knob's range (each ordinal knob's extremes are
        guaranteed to appear once n >= 2).  Uniform random init can miss an
        entire side of an ordinal knob with probability ((k-1)/k)^n — fatal
        when the tuning budget is a short serving window."""
        cols = []
        for k in self.knobs:
            if k.kind == "continuous":
                lo, hi = k.values
                vals = ([lo + (hi - lo) * i / (n - 1) for i in range(n)]
                        if n > 1 else [0.5 * (lo + hi)])
                rng.shuffle(vals)
                cols.append(vals)
                continue
            m = len(k.values)
            if k.kind == "ordinal" and m > 1 and n > 1:
                idx = [round(i * (m - 1) / (n - 1)) for i in range(n)]
            else:
                idx = [i % m for i in range(n)]
            rng.shuffle(idx)
            cols.append([k.values[i] for i in idx])
        names = self.names()
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    def neighbors(self, setting: dict, rng: _random.Random, n: int = 8):
        """Local perturbations (one knob moved) — candidate pool for EI."""
        out = []
        for _ in range(n):
            s = dict(setting)
            k = rng.choice(self.knobs)
            if k.kind == "continuous":
                lo, hi = k.values
                s[k.name] = k.clip(s[k.name] + rng.gauss(0.0,
                                                         0.15 * (hi - lo)))
            elif k.kind == "ordinal" and len(k.values) > 1:
                idx = k.values.index(s[k.name])
                step = rng.choice([-1, 1])
                idx = min(len(k.values) - 1, max(0, idx + step))
                s[k.name] = k.values[idx]
            else:
                s[k.name] = rng.choice(k.values)
            out.append(s)
        return out

    def has_continuous(self) -> bool:
        return any(k.kind == "continuous" for k in self.knobs)

    def enumerate_all(self, limit: int = 4096):
        if self.has_continuous():
            return None                    # uncountable: sample instead
        vals = [k.values for k in self.knobs]
        total = 1
        for v in vals:
            total *= len(v)
        if total > limit:
            return None
        names = self.names()
        return [dict(zip(names, combo)) for combo in itertools.product(*vals)]

    def size(self) -> float:
        total = 1.0
        for k in self.knobs:
            if k.kind == "continuous":
                return float("inf")
            total *= len(k.values)
        return total


def default_ps_knob_space(n_devices: int = 1,
                          include_mesh: bool = True) -> KnobSpace:
    """The STPS analogue of the paper's Table I knob set; ``mesh_split``
    as (dp, tp) tuples, every power-of-two dp that divides the devices."""
    knobs = [
        Knob("microbatches", "ordinal", (1, 2, 4, 8)),
        Knob("remat", "nominal", ("none", "dots", "full")),
        Knob("compression", "nominal", ("none", "bf16", "int8")),
        Knob("staleness", "ordinal", (0, 1, 2, 4)),
        Knob("k_chunk", "ordinal", (256, 512, 1024, 2048)),
        Knob("ce_chunk", "ordinal", (0, 512, 1024)),
        Knob("scan_unroll", "ordinal", (1, 2)),
    ]
    if include_mesh and n_devices > 1:
        splits = []
        dp = 1
        while dp <= n_devices:
            if n_devices % dp == 0:
                splits.append((dp, n_devices // dp))
            dp *= 2
        knobs.append(Knob("mesh_split", "nominal", tuple(splits)))
    return KnobSpace(tuple(knobs))


def setting_key(setting: dict) -> tuple:
    return tuple(sorted(setting.items()))
