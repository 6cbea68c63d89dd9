#!/usr/bin/env python3
"""The dry run's cells as one markdown table, a row an architecture and a
column a shape; each cell gives, for 16x16 and then 2x16x16, whether it
fits a card, its peak GB a device, its bottleneck and its compute /
memory / collective seconds.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out build/dryrun_all
  python3 scripts/dryrun_table.py build/dryrun_all

Reads the JSONs ``launch/dryrun.py`` wrote (``<arch>__<shape>__pod.json``
and ``...__multipod.json``); a cell missing on one mesh shows "-".
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(r) -> str:
    if r is None:
        return "-"
    rl, mem = r["roofline"], r["memory"]
    fits = "fits" if mem["fits"] else "**no**"
    return (f"{fits} {mem['peak_estimate_bytes'] / 1e9:.1f} GB, "
            f"{rl['bottleneck']} ({rl['compute_s']:.3g} / "
            f"{rl['memory_s']:.3g} / {rl['collective_s']:.3g} s)")


def main(argv=None):
    d = Path((argv or sys.argv[1:] or ["build/dryrun"])[0])
    runs = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        runs[(r["arch"], r["shape"], r["multi_pod"])] = r
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for a in sorted({k[0] for k in runs}):
        row = []
        for s in SHAPES:
            pod, multi = runs.get((a, s, False)), runs.get((a, s, True))
            row.append("-" if pod is None and multi is None else
                       f"{cell(pod)}; {cell(multi)}")
        print(f"| {a} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
