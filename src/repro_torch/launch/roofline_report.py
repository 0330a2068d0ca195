"""Roofline report: renders the port's dry-run sweep (one JSON per cell from
``launch/dryrun.py``) as a table and checks coverage: every applicable
(arch x shape) cell present on both production meshes, all ok.  The twin of
``benchmarks/roofline_report.py``, with the peak memory and whether it fits
the card beside the roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report --results results/dryrun_torch

Every number is counted on the CPU from fake tensors: no card ran.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import configs
from repro_torch.models.config import applicable_shapes

RESULTS = pathlib.Path("results/dryrun_torch")
MESHES = ("pod16x16", "pod2x16x16")
HEADER = ["arch", "shape", "mesh", "comp_s", "mem_s", "coll_s", "dominant", "useful", "roof%",
          "peak_GB", "fits"]


def expected_cells():
    return [(arch, s.name, mesh) for arch in configs.ARCH_IDS
            for s in applicable_shapes(configs.get(arch)) for mesh in MESHES]


def _row(d) -> list:
    if d["status"] != "ok":
        return [d["arch"], d["shape"], d["mesh"], "FAIL", "", "", "", "", "", "", d.get("error", "")]
    r, m = d["roofline"], d["memory"]
    return [
        d["arch"], d["shape"], d["mesh"],
        f"{r['compute_s']:.3f}", f"{r['memory_s']:.3f}", f"{r['collective_s']:.3f}",
        r["dominant"], f"{r['useful_ratio']:.3f}", f"{r['roofline_fraction'] * 100:.2f}%",
        f"{m['peak_size_in_bytes'] / 1e9:.1f}", "yes" if m["fits"] else "no",
    ]


def fmt_table(header, rows) -> str:
    """A markdown table."""
    lines = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    lines += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return "\n".join(lines)


def run(results: pathlib.Path = RESULTS) -> dict:
    found = {}
    for f in sorted(results.glob("*.json")) if results.exists() else []:
        d = json.loads(f.read_text())
        found[(d["arch"], d["shape"], d["mesh"])] = d
    expected = expected_cells()
    missing = [c for c in expected if c not in found]
    failed = [k for k, d in found.items() if d["status"] != "ok"]
    rows = [_row(found[c]) for c in expected if c in found]
    return {
        "name": "Roofline — dry-run terms per (arch x shape x mesh), counted on the CPU",
        "table": fmt_table(HEADER, rows),
        "rows": rows,
        "coverage": {"ok": not missing and not failed, "cells": len(found),
                     "missing": missing, "failed": failed},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args()
    out = run(pathlib.Path(args.results))
    print(out["name"])
    print(out["table"])
    cov = out["coverage"]
    print(f"coverage: {cov['cells']} cells; missing={len(cov['missing'])} failed={len(cov['failed'])}")
    if not cov["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
