"""Persistent, concurrency-safe tuning knowledge store.

MITuna runs tuning as a DB-backed fleet; this is the sqlite-free analogue
sized for N serving processes on a shared filesystem:

  <root>/
    LOCK                      advisory flock file (never holds data)
    segments/<sid>.jsonl      one append-only segment per writer session
    GOLDEN.json               compacted golden-knobs table (store.golden)

Concurrency protocol (documented + gated in docs/TUNING_STORE.md):

  * writers take a SHARED flock on LOCK for the life of their session and
    append only to their own segment — no write ever contends with another
    writer, and no segment is ever mutated in place;
  * compaction takes an EXCLUSIVE flock (so it can only run when no writer
    session is open), merge-sorts every segment by stamp and rewrites them
    as one, deduplicating on the (sid, seq) identity so a reader racing a
    compaction never double-counts;
  * readers take NO lock: they snapshot the segment listing, parse each
    file, dedupe, and merge-sort by stamp — a torn final line (a writer
    mid-append) is skipped, never fatal;
  * a writer that cannot get the shared lock within ``lock_timeout_s``
    (e.g. a compactor wedged mid-rewrite) degrades to a READ-ONLY session:
    warm-start still works, new observations are dropped with a counter.

Every record is one JSON line stamped ``[unix_time, sid, seq]``; the
stamp is unique (sid is a per-session random id, seq a per-session
counter) and sorts observations into one fleet-wide monotonic history.
"""
from __future__ import annotations

import json
import os
import time
import uuid

try:
    import fcntl
except ImportError:                       # non-POSIX: single-process only
    fcntl = None

from repro_torch.store.signature import TuningSignature, fallback_tiers

SCHEMA_VERSION = 1

# on-disk record schema, per record kind — docs/TUNING_STORE.md carries a
# row per field and tests/test_docs.py fails if either side drifts
SCHEMA_FIELDS = {
    "obs": ("v", "kind", "sig", "stamp", "setting", "loss", "Y"),
    "decision": ("v", "kind", "sig", "stamp", "window", "phase", "candidate",
                 "incumbent", "switched", "reason", "ei_s",
                 "predicted_cost_s"),
}


def _jsonable(v):
    """Numpy scalars -> Python; non-finite floats -> None (strict JSON)."""
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
        return None
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class _FileLock:
    """Advisory flock wrapper with a bounded non-blocking acquire loop."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def acquire(self, exclusive: bool, timeout_s: float) -> bool:
        if fcntl is None:
            return True
        mode = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        self._fh = open(self.path, "a")
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fcntl.flock(self._fh, mode | fcntl.LOCK_NB)
                return True
            except OSError:
                if time.monotonic() >= deadline:
                    self._fh.close()
                    self._fh = None
                    return False
                time.sleep(0.01)

    def release(self):
        if self._fh is not None:
            if fcntl is not None:
                fcntl.flock(self._fh, fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None


class StoreSession:
    """One writer's bound view of the store: appends go to a private
    segment under a shared lock; ``read_only`` sessions drop appends."""

    def __init__(self, store: "TuningStore", sig_key: str):
        self.store = store
        self.sig_key = sig_key
        self.sid = uuid.uuid4().hex[:12]
        self._seq = 0
        self.dropped = 0               # appends lost to read-only fallback
        self._lock = _FileLock(store.lock_path)
        self.read_only = not self._lock.acquire(
            exclusive=False, timeout_s=store.lock_timeout_s)
        self._fh = None
        if not self.read_only:
            self._fh = open(os.path.join(store.segments_dir,
                                         f"{self.sid}.jsonl"), "a")

    # ------------------------------------------------------------- appends
    def _append(self, kind: str, payload: dict):
        if self.read_only or self._fh is None:
            self.dropped += 1
            return
        rec = {"v": SCHEMA_VERSION, "kind": kind, "sig": self.sig_key,
               "stamp": [time.time(), self.sid, self._seq]}
        rec.update(payload)
        self._seq += 1
        self._fh.write(json.dumps(_jsonable(rec)) + "\n")
        self._fh.flush()               # every quantum's evidence is durable

    def record_observation(self, setting: dict, loss: float, Y: float):
        """One BO training triple <setting, context, objective>.  Divergent
        windows (non-finite Y) are not evidence worth sharing."""
        Y = float(Y)
        if not (Y == Y and Y != float("inf")):
            return
        self._append("obs", {"setting": dict(setting),
                             "loss": float(loss), "Y": Y})

    def record_decision(self, rec: dict):
        """Persist an audited deliberation (TuningAudit decision record) —
        the fleet-wide audit trail of why settings were adopted."""
        self._append("decision", {
            k: rec.get(k) for k in SCHEMA_FIELDS["decision"]
            if k not in ("v", "kind", "sig", "stamp")})

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._lock.release()


class TuningStore:
    def __init__(self, root: str, lock_timeout_s: float = 2.0):
        self.root = root
        self.lock_timeout_s = lock_timeout_s
        self.segments_dir = os.path.join(root, "segments")
        os.makedirs(self.segments_dir, exist_ok=True)
        self.lock_path = os.path.join(root, "LOCK")
        self.golden_path = os.path.join(root, "GOLDEN.json")

    # ------------------------------------------------------------ sessions
    def session(self, sig: "TuningSignature | str") -> StoreSession:
        key = sig if isinstance(sig, str) else sig.key
        return StoreSession(self, key)

    # ------------------------------------------------------------- reading
    def _segment_files(self) -> list[str]:
        try:
            names = sorted(os.listdir(self.segments_dir))
        except FileNotFoundError:
            return []
        return [os.path.join(self.segments_dir, n) for n in names
                if n.endswith(".jsonl")]

    def read_records(self, kinds: tuple = ("obs", "decision")) -> list[dict]:
        """Lock-free merged view: every segment parsed, deduped on the
        (sid, seq) stamp identity, merge-sorted by stamp."""
        recs, seen = [], set()
        for path in self._segment_files():
            try:
                with open(path) as f:
                    lines = f.readlines()
            except FileNotFoundError:     # compaction removed it mid-listing
                continue
            for line in lines:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue              # torn tail of an in-flight append
                stamp = rec.get("stamp")
                if not (isinstance(stamp, list) and len(stamp) == 3):
                    continue
                ident = (stamp[1], stamp[2])
                if ident in seen or rec.get("kind") not in kinds:
                    continue
                seen.add(ident)
                recs.append(rec)
        recs.sort(key=lambda r: (r["stamp"][0], r["stamp"][1], r["stamp"][2]))
        return recs

    def observations_for(self, sig: "TuningSignature | str"):
        """Warm-start source resolution: returns ``(obs, matched_key,
        tier)`` for the nearest signature with history — exact key first,
        then same model+pool (any workload bucket), then same family.
        All keys matching the winning tier pool together (that *is* the
        cross-process merge)."""
        if isinstance(sig, str):
            sig = TuningSignature.from_key(sig)
        all_obs = self.read_records(kinds=("obs",))
        for tier, match in fallback_tiers(sig):
            hits = [r for r in all_obs if match(r["sig"])]
            if hits:
                keys = {r["sig"] for r in hits}
                matched = sig.key if tier == "exact" else sorted(keys)[0]
                return hits, matched, tier
        return [], None, None

    # ---------------------------------------------------------- compaction
    def compact(self) -> bool:
        """Merge every segment into one, under the exclusive lock.  Returns
        False (store untouched) when a writer session holds the shared
        lock or a competing compactor holds the exclusive one."""
        lock = _FileLock(self.lock_path)
        if not lock.acquire(exclusive=True, timeout_s=self.lock_timeout_s):
            return False
        try:
            files = self._segment_files()
            if len(files) <= 1:
                return True
            recs = self.read_records()
            sid = f"compact-{uuid.uuid4().hex[:8]}"
            tmp = os.path.join(self.segments_dir, f".{sid}.tmp")
            with open(tmp, "w") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, os.path.join(self.segments_dir, f"{sid}.jsonl"))
            for path in files:
                os.unlink(path)
            return True
        finally:
            lock.release()

    # -------------------------------------------------------------- golden
    def build_golden(self, top_k: int = 5, decay: float = 0.9) -> dict:
        from repro_torch.store.golden import reduce_golden
        return reduce_golden(self.read_records(kinds=("obs",)),
                             top_k=top_k, decay=decay)

    def write_golden(self, path: str | None = None, top_k: int = 5,
                     decay: float = 0.9) -> dict:
        from repro_torch.store.golden import write_golden
        table = self.build_golden(top_k=top_k, decay=decay)
        write_golden(path or self.golden_path, table)
        return table
