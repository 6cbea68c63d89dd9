"""Serving-time system-setting space (paper §III applied to inference).

Every knob changes only efficiency, never which tokens are produced — with
the one documented exception of ``quant``/``cache_dtype``, which trade KV
precision for memory/bandwidth the way the paper's bfloat16_sendrecv knob
trades push precision (the greedy argmax is empirically insensitive at the
scales served here, and the engine's reference test pins the exact-output
settings).

Knob classes for reconfiguration planning (repro.core.reconfig):
  * ``max_batch`` / ``cache_dtype`` / ``block_size`` re-layout the state
    pool — model-data relocation, Type I-b, executed ODMR-style at block
    granularity (allocate the new pool, relocate live blocks/slots, no
    quiesce of the request queue);
  * everything else only swaps the compiled step or the admission policy —
    Type II (SSR).

``admit_budget`` is a continuous knob (prefills admitted per scheduling
quantum while decodes run, fractional values accumulate): the ROADMAP's
"continuous-valued knobs" item.  ``block_overcommit`` is the second
continuous knob: the usable-block budget as a fraction of the dense
worst case (max_batch full sequences).  Below 1.0 admission genuinely
contends on blocks — the paging win — at the risk of admission stalls
and prefix-cache evictions.  The pool arrays stay shaped for the worst
case, so a budget move is a free-list rebalance (Type II policy swap):
the BO can perturb a continuous knob without ever forcing a pool
re-layout or a decode-executable recompile.  ``prefix_share`` gates
copy-on-write prompt-prefix sharing in the paged pool.  SSM/hybrid
families have no KV sequence axis, so their space drops the paging and
quantization knobs.
"""
from __future__ import annotations

from repro_torch.core.knobs import Knob, KnobSpace

# Type I-b knobs: changing them relocates the state pool (the serving
# engine's "model data"). Passed to reconfig.classify/plan as mesh_knobs.
SERVING_RELAYOUT_KNOBS = ("max_batch", "cache_dtype", "block_size")

PAGED_FAMILIES = ("dense", "moe", "vlm")


def serving_knob_space(max_batch_ceiling: int = 8,
                       include_batches: tuple = (),
                       family: str = "dense") -> KnobSpace:
    # the ceiling (and any caller-supplied x0 value) is always a member, so
    # every starting setting encodes into the space
    batches = tuple(sorted({b for b in (1, 2, 4, 8, 16)
                            if b <= max_batch_ceiling}
                           | {max_batch_ceiling}
                           | {b for b in include_batches
                              if 1 <= b <= max_batch_ceiling}))
    knobs = [
        Knob("max_batch", "ordinal", batches),
        Knob("prefill_chunk", "ordinal", (16, 32)),
        Knob("k_chunk", "ordinal", (128, 256)),
        Knob("cache_dtype", "nominal", ("bf16", "f32")),
        Knob("admit_budget", "continuous", (0.5, 4.0)),
        # speculative decoding: spec_k drafts per verify step (the engine
        # rounds/clamps; 0 = off) and which Drafter proposes them.  Both
        # are Type II — drafters keep host token histories only, and the
        # S = spec_k+1 verify executable is just another LRU entry.
        Knob("spec_k", "continuous", (0.0, 4.0)),
        Knob("drafter", "nominal", ("ngram", "truncated")),
    ]
    if family in PAGED_FAMILIES:
        knobs += [
            Knob("quant", "nominal", ("none", "int8")),
            Knob("block_size", "ordinal", (8, 16)),
            Knob("prefix_share", "bool", (False, True)),
            Knob("block_overcommit", "continuous", (0.5, 1.0)),
        ]
    return KnobSpace(tuple(knobs))


# Mirrors the pre-engine one-shot script: one request at a time, conservative
# precision, no sharing — the fixed baseline the benchmarks compare against.
DEFAULT_SERVING_SETTING = {
    "max_batch": 1,
    "prefill_chunk": 16,
    "quant": "none",
    "k_chunk": 128,
    "cache_dtype": "f32",
    "block_size": 16,
    "prefix_share": False,
    "admit_budget": 1.0,
    "block_overcommit": 1.0,
    "spec_k": 0.0,
    "drafter": "ngram",
}
