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

  python3 scripts/dryrun_table.py build/dryrun_all --before DIR

compares two runs (``DIR``: the JSONs of another tree's dry run, e.g. a
``git archive`` of the parent commit run the same way), a row an
(architecture, shape) and a column a mesh: whether it fits, its peak GB
a device, its counted FLOPs a device (F) and its collective GB a device
by kind (all-gather / all-reduce / reduce-scatter), before -> after,
beside the analytic model's FLOPs; then the cells that fit on each side.
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


def load(d: Path) -> dict:
    runs = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        runs[(r["arch"], r["shape"], r["multi_pod"])] = r
    return runs


def compare(after: dict, before: dict):
    def side(r):
        c = r["collectives"]
        return (f"{'fits' if r['memory']['fits'] else '**no**'} "
                f"{r['memory']['peak_estimate_bytes'] / 1e9:.1f} GB, "
                f"{r['flops_counted_dev']:.3g} F, "
                + "/".join(f"{c[k] / 1e9:.3g}" for k in
                           ("all-gather", "all-reduce", "reduce-scatter")))

    print("| arch | shape | 16x16 before -> after | 2x16x16 before -> "
          "after |")
    print("|---|---|---|---|")
    for a, sh in sorted({(k[0], k[1]) for k in after}):
        cells = []
        for mp in (False, True):
            k = (a, sh, mp)
            if k in after and k in before:
                flops = after[k]["analytic"]["flops_dev"]
                cells.append(f"{side(before[k])} -> {side(after[k])} "
                             f"(analytic {flops:.3g} F)")
            else:
                cells.append("-")
        print(f"| {a} | {sh} | {cells[0]} | {cells[1]} |")
    for name, runs in (("before", before), ("after", after)):
        no = [k for k, r in runs.items() if not r["memory"]["fits"]]
        print(f"{name}: {len(runs) - len(no)} of {len(runs)} cells fit; "
              f"not: " + ", ".join(f"{a} {s} {'2x16x16' if m else '16x16'}"
                                   for a, s, m in sorted(no)))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--before" in argv:
        i = argv.index("--before")
        before = load(Path(argv[i + 1]))
        del argv[i:i + 2]
        compare(load(Path((argv or ["build/dryrun"])[0])), before)
        return
    runs = load(Path((argv or ["build/dryrun"])[0]))
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
