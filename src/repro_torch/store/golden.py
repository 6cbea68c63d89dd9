"""Golden-knobs tables: merged history reduced to "what to run next time".

MIOpen's find_db answers "best kernel for this (arch, problem)" without
re-tuning; the serving analogue is "best knob setting for this (model,
pool, workload-bucket)".  ``reduce_golden`` folds the store's merged
observation history into one entry per signature:

  * ``incumbent``  — the setting with the best recency-decayed mean
    objective (lower Y = better), with its observation count;
  * ``top_k``      — the next-best settings with their decayed means, the
    "posterior shortlist" a warm-started BO explores first;
  * ``n_obs``      — total observations behind the entry (trust weight).

Recency decay (newest observation weight 1, each older one ``decay``x
less) matters because the fleet's hosts and workloads drift: a setting
that won six months of history must not outvote last week's evidence
forever.
"""
from __future__ import annotations

import json
import os

from repro_torch.core.knobs import setting_key
from repro_torch.store.signature import TuningSignature, fallback_tiers

GOLDEN_VERSION = 1


def reduce_golden(obs_records: list[dict], top_k: int = 5,
                  decay: float = 0.9) -> dict:
    """Merged obs records (already stamp-sorted, oldest first) -> table."""
    by_sig: dict[str, list[dict]] = {}
    for rec in obs_records:
        if rec.get("kind") != "obs":
            continue
        by_sig.setdefault(rec["sig"], []).append(rec)
    entries = {}
    for sig, recs in by_sig.items():
        # newest gets weight 1; the i-th newest decay**i
        per_setting: dict[tuple, dict] = {}
        n = len(recs)
        for i, rec in enumerate(recs):
            w = decay ** (n - 1 - i)
            row = per_setting.setdefault(setting_key(rec["setting"]), {
                "setting": dict(rec["setting"]), "n": 0,
                "w_sum": 0.0, "wy_sum": 0.0, "last_stamp": rec["stamp"]})
            row["n"] += 1
            row["w_sum"] += w
            row["wy_sum"] += w * float(rec["Y"])
            row["last_stamp"] = rec["stamp"]
        ranked = sorted(per_setting.values(),
                        key=lambda r: r["wy_sum"] / r["w_sum"])
        rows = [{"setting": r["setting"],
                 "Y_decayed": round(r["wy_sum"] / r["w_sum"], 6),
                 "n": r["n"], "last_stamp": r["last_stamp"]}
                for r in ranked]
        entries[sig] = {
            "incumbent": rows[0],
            "top_k": rows[:top_k],
            "n_obs": n,
            "n_settings": len(rows),
        }
    return {"version": GOLDEN_VERSION, "entries": entries}


def lookup(table: dict, sig: "TuningSignature | str"):
    """Resolve ``sig`` against a golden table through the same fallback
    order the store uses: returns ``(entry, matched_key, tier)`` or
    ``(None, None, None)``.  At a non-exact tier the entry with the most
    observations wins (trust the best-evidenced neighbour)."""
    if isinstance(sig, str):
        sig = TuningSignature.from_key(sig)
    entries = table.get("entries", {})
    for tier, match in fallback_tiers(sig):
        hits = {k: e for k, e in entries.items() if match(k)}
        if hits:
            key = (sig.key if tier == "exact"
                   else max(hits, key=lambda k: hits[k]["n_obs"]))
            return hits[key], key, tier
    return None, None, None


def write_golden(path: str, table: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)                 # readers never see a torn table
    return path


def load_golden(path: str) -> dict:
    with open(path) as f:
        table = json.load(f)
    assert table.get("version") == GOLDEN_VERSION, \
        f"golden table version {table.get('version')} != {GOLDEN_VERSION}"
    return table


def check_golden(table: dict) -> None:
    """Well-formedness gate (scripts/ci.sh): every entry carries an
    incumbent with a setting and decayed objective, counts are coherent."""
    assert table.get("version") == GOLDEN_VERSION, "bad golden version"
    for sig, e in table.get("entries", {}).items():
        TuningSignature.from_key(sig)     # key parses
        assert e["n_obs"] >= e["n_settings"] >= 1, f"{sig}: bad counts"
        assert e["top_k"] and e["incumbent"] == e["top_k"][0], \
            f"{sig}: incumbent is not the top-ranked row"
        for row in e["top_k"]:
            assert isinstance(row["setting"], dict) and row["setting"], \
                f"{sig}: empty setting row"
            assert row["n"] >= 1 and isinstance(row["Y_decayed"], float), \
                f"{sig}: malformed ranked row"
