"""Canonical tuning-signature keys for the fleet knowledge store.

A tuned incumbent is only transferable between runs that pose the *same*
tuning problem: same model (the executables being timed), same pool
geometry (the state being relaid out), and a workload close enough that
the <setting, load> -> Y surface the GP learned still applies.  MITuna's
find_db keys configs by (arch, problem); here the problem is the traffic,
so the key's third component is a *quantized workload fingerprint* —
arrival rate, prompt/generation length, and prefix-share ratio collapsed
into coarse buckets.  Bucketing is the whole point: exact traffic never
recurs, but "~32 req/s of short shared-prefix prompts" does, and every
run inside a bucket should pool its observations.

Key layout (three `|`-separated components, each `:`-separated inside):

    model|pool|workload
    starcoder2-3b:dense:ab12cd34 | paged:seq96 | r5:p4:g4:s0

Fallback order for warm-starting (exact -> same model+pool with any
workload -> same model family): ``fallback_tiers`` returns the match
predicates in order; the store and the golden table both resolve through
it so provenance ("matched at tier X") means the same thing everywhere.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass

# match tiers, strongest first (the provenance strings in audits/panels)
TIERS = ("exact", "pool", "family")


# ----------------------------------------------------------- model / pool
def model_tag(cfg) -> str:
    """``name:family:hash8`` — the hash covers every architectural field,
    so a --reduced config never pools with the full-size one."""
    blob = repr(sorted(dataclasses.asdict(cfg).items())).encode()
    return (f"{cfg.name}:{cfg.family}:"
            f"{hashlib.sha256(blob).hexdigest()[:8]}")


def pool_tag(pool_kind: str, max_seq: int) -> str:
    return f"{pool_kind}:seq{int(max_seq)}"


# ------------------------------------------------------ workload buckets
def _log2_bucket(v: float) -> int:
    return int(round(math.log2(max(float(v), 1e-9))))


def workload_stats(trace, duration_s: float | None = None) -> dict:
    """Raw traffic statistics from a ``serving/workload.py``-shaped trace
    (any iterable of Requests: ``prompt``, ``max_new``, ``arrival_s``).

    ``share_ratio`` is a cheap prefix-recurrence proxy: the fraction of
    requests whose leading 16 tokens were already seen earlier in the
    trace — ~0 for independent prompts, ~1 for template traffic."""
    reqs = list(trace)
    if not reqs:
        return {"rate_rps": 0.0, "mean_prompt": 0.0, "mean_new": 0.0,
                "share_ratio": 0.0, "n_requests": 0}
    arrivals = [float(r.arrival_s) for r in reqs]
    span = duration_s if duration_s else max(arrivals) - min(arrivals)
    seen: set = set()
    shared = 0
    plens, news = [], []
    for r in reqs:
        plens.append(len(r.prompt))
        news.append(int(r.max_new))
        head = tuple(int(t) for t in r.prompt[:16])
        if head in seen:
            shared += 1
        seen.add(head)
    return {
        "rate_rps": len(reqs) / max(span, 1e-9),
        "mean_prompt": sum(plens) / len(plens),
        "mean_new": sum(news) / len(news),
        "share_ratio": shared / len(reqs),
        "n_requests": len(reqs),
    }


def quantize_workload(stats: dict) -> str:
    """Stats -> coarse bucket string ``r<log2 rate>:p<log2 plen>:
    g<log2 gen>:s<share quartile>``.  Buckets are wide on purpose:
    observations transfer across small load drift, and a run on a 10%
    faster host still lands in the same cell."""
    r = _log2_bucket(stats["rate_rps"])
    p = _log2_bucket(stats["mean_prompt"])
    g = _log2_bucket(stats["mean_new"])
    s = min(3, int(float(stats["share_ratio"]) * 4))   # quartiles of [0,1)
    return f"r{r}:p{p}:g{g}:s{s}"


# -------------------------------------------------------------- signature
@dataclass(frozen=True)
class TuningSignature:
    model: str                    # name:family:hash8
    pool: str                     # kind:seqN
    workload: str                 # rX:pX:gX:sX

    @property
    def key(self) -> str:
        return f"{self.model}|{self.pool}|{self.workload}"

    @property
    def family(self) -> str:
        parts = self.model.split(":")
        return parts[1] if len(parts) >= 2 else self.model

    @staticmethod
    def from_key(key: str) -> "TuningSignature":
        model, pool, workload = key.split("|")
        return TuningSignature(model=model, pool=pool, workload=workload)

    def matches(self, other_key: str, tier: str) -> bool:
        """Does ``other_key`` serve as a warm-start source at ``tier``?"""
        try:
            o = TuningSignature.from_key(other_key)
        except ValueError:
            return False
        if tier == "exact":
            return o == self
        if tier == "pool":
            return o.model == self.model and o.pool == self.pool
        if tier == "family":
            return o.family == self.family
        raise ValueError(f"unknown match tier {tier!r}")


def fallback_tiers(sig: TuningSignature):
    """Ordered (tier_name, predicate-over-key) pairs, strongest first."""
    return [(t, lambda key, t=t: sig.matches(key, t)) for t in TIERS]


def compute_signature(cfg, pool_kind: str, max_seq: int,
                      stats: dict) -> TuningSignature:
    return TuningSignature(model=model_tag(cfg),
                           pool=pool_tag(pool_kind, max_seq),
                           workload=quantize_workload(stats))


def signature_from_trace(cfg, pool_kind: str, max_seq: int, trace,
                         duration_s: float | None = None) -> TuningSignature:
    return compute_signature(cfg, pool_kind, max_seq,
                             workload_stats(trace, duration_s))
