"""Fleet-scale tuning knowledge store: the port's copy of the JAX
package's ``store/`` (stdlib only, imports rewritten).  The
on-disk schema (``SCHEMA_FIELDS``), the flock protocol and the match tiers
are unchanged, so either package reads a store the other wrote
(docs/TUNING_STORE.md).

Persists what each process's self-tuning loop learns — BO observations
and audited decisions, keyed by a canonical (model, pool geometry,
quantized workload) signature — so the next process warm-starts its GP
from prior posteriors instead of LHS-from-scratch, observations merge
across concurrent writers, and a find_db-style golden-knobs table records
the fleet's best-known setting per signature.
"""
from repro_torch.store.golden import (check_golden, load_golden, lookup,
                                reduce_golden, write_golden)
from repro_torch.store.signature import (TuningSignature, compute_signature,
                                   fallback_tiers, model_tag, pool_tag,
                                   quantize_workload, signature_from_trace,
                                   workload_stats)
from repro_torch.store.store import (SCHEMA_FIELDS, StoreSession, TuningStore)

__all__ = ["TuningStore", "StoreSession", "SCHEMA_FIELDS",
           "TuningSignature", "compute_signature", "signature_from_trace",
           "workload_stats", "quantize_workload", "fallback_tiers",
           "model_tag", "pool_tag",
           "reduce_golden", "lookup", "write_golden", "load_golden",
           "check_golden"]
