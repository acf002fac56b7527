"""Render the dry-run / roofline tables from the dry-run JSON results.

Copied from ``src/repro/launch/report.py``, on the port's records
(``launch/dryrun.py``): no compile, so the columns are the trace's
seconds and the bytes a rank holds of the step's arguments; a collective
term the meta pass could not count prints as unavailable.

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def load(outdir):
    cells = {}
    for f in sorted(Path(outdir).glob("*.json")):
        r = json.loads(f.read_text())
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_table(cells, mesh="pod16x16"):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "roofline frac | useful (6ND/analytic) | arg GB/dev | args fit 80GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | — | — | skipped | — | — "
                         f"| — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR: {r['error'][:60]} |"
                         + " — |" * 8)
            continue
        t = r["roofline"]
        gb = r["memory"].get("argument_bytes_per_device", 0) / 1e9
        fits = "yes" if gb < 80 else "no"
        coll = ("unavailable" if t["collective_s"] is None
                else f"{t['collective_s']:.4f}")
        lines.append(
            f"| {arch} | {shape} | {t['compute_s']:.4f} | {t['memory_s']:.4f}"
            f" | {coll} | {t['dominant']} |"
            f" {t['roofline_fraction']:.3f} | {t['useful_ratio']:.2f} |"
            f" {gb:.1f} | {fits} |")
    return "\n".join(lines)


def fmt_dryrun_summary(cells):
    ok = sum(1 for r in cells.values() if r["status"] == "ok")
    skip = sum(1 for r in cells.values() if r["status"] == "skipped")
    err = sum(1 for r in cells.values() if r["status"] == "error")
    lines = [f"cells: {len(cells)} — ok {ok}, skipped {skip}, error {err}", ""]
    lines.append("| arch | shape | mesh | trace s | arg GB/dev | "
                 "collective ops (AG/AR/RS/A2A/CP) |")
    lines.append("|---|---|---|---|---|---|")
    for (arch, shape, m), r in sorted(cells.items()):
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        c = t["coll_breakdown"].get("_counts")
        counts = ("unavailable" if c is None else
                  f"{c['all-gather']:g}/{c['all-reduce']:g}/"
                  f"{c['reduce-scatter']:g}/{c['all-to-all']:g}/"
                  f"{c['collective-permute']:g}")
        arggb = r["memory"].get("argument_bytes_per_device", 0) / 1e9
        lines.append(f"| {arch} | {shape} | {m} | {r['trace_s']} |"
                     f" {arggb:.2f} | {counts} |")
    return "\n".join(lines)


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    cells = load(outdir)
    print("## Roofline (single-pod 16x16)\n")
    print(fmt_table(cells))
    print("\n## Dry-run summary (both meshes)\n")
    print(fmt_dryrun_summary(cells))


if __name__ == "__main__":
    main()
