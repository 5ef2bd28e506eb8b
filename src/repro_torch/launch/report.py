"""The dry run's tables from the per-cell JSONs written by
``repro_torch.launch.dryrun``: the port of the JAX package's
``repro/launch/report.py`` under the port's key names
(``dot_flops_per_dev``, ``trace_s``). The terms are analytic, on the H100
datasheet peaks of ``launch/roofline.py::HW``.

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dir experiments/dryrun_torch] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1.0:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def load(dirname):
    recs = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def roofline_table(recs, mesh="16x16"):
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "frac | useful | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("overrides"):
            continue
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                         f"| - | N/A: {r['reason'][:42]} |")
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                         f"| - | FAILED |")
            continue
        mv = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r.get('t_compute_s'))} | "
            f"{fmt_s(r.get('t_memory_s'))} | {fmt_s(r.get('t_collective_s'))} "
            f"| {r.get('dominant', '-')} | "
            f"{r.get('roofline_fraction', 0):.3f} | "
            f"{'-' if mv is None else f'{mv:.2f}'} |  |")
    return "\n".join(lines)


def dryrun_table(recs):
    rows = []
    for r in recs:
        if r.get("overrides"):
            continue
        status = "SKIP" if r.get("skipped") else (
            "ok" if r.get("ok") else "FAIL")
        fl = r.get("dot_flops_per_dev")
        cb = r.get("collective_bytes_per_dev")
        pb = r.get("param_bytes_per_dev")
        rows.append("| {} | {} | {} | {} | {} | {} | {} | {} |".format(
            r["arch"], r["shape"], r.get("mesh", "-"),
            r.get("trace_s", "-"),
            f"{fl / 1e12:.2f}T" if fl else "-",
            fmt_bytes(cb), fmt_bytes(pb), status))
    hdr = ["| arch | shape | mesh | trace_s | dot flops/dev | "
           "coll wire/dev | param bytes/dev | status |",
           "|---|---|---|---|---|---|---|---|"]
    return "\n".join(hdr + rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load(args.dir)
    print("## Dry-run matrix\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline ({args.mesh}; analytic, H100 SXM5 datasheet "
          f"peaks)\n")
    print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
