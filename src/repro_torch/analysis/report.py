"""Markdown tables of steps' rooflines and of a recording's kernels: the
counterpart of ``repro/analysis/report.py``.

    PYTHONPATH=src python -m repro_torch.analysis.report ROWS.json \
        [--base BASE.json]

``ROWS.json`` holds ``{"roofline": [row, ...], "kernels": {title:
{"snapshot": ..., "device_ms": ...}, ...}}`` (either key may be absent):
a row is ``{"name": ..., **Roofline.row()}``, a snapshot
``kernels.profile.snapshot()`` and ``device_ms`` the device milliseconds
by kernel (``profile.device_ms``). ``chip_smoke.py`` writes one to
``build/analysis.json``. With ``--base`` the steps present in both files
are compared. ``--dryrun DIR`` prints the dry run's artifacts
(``launch/dryrun.py``) as :func:`dryrun_table` and their rooflines.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.analysis import roofline


def _f(x, fmt: str) -> str:
    return "not measured" if x is None else format(x, fmt)


def roofline_table(rows: List[Dict]) -> str:
    lines = [
        "| step | measured ms | compute ms | memory ms | collective ms | "
        "dominant | useful FLOPs ratio | MFU bound | MFU | share |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['measured_s'] * 1e3:.2f} | "
            f"{r['compute_s'] * 1e3:.3f} | {r['memory_s'] * 1e3:.3f} | "
            f"{r['collective_s'] * 1e3:.3f} | **{r['dominant']}** | "
            f"{r['useful_flops_ratio']:.3f} | {r['mfu_bound']:.1%} | "
            f"{r['mfu']:.3g} | {r['share']:.3g} |")
    return "\n".join(lines)


def kernel_rows(snapshot: Dict[str, Dict], device_ms: Dict[str, float],
                rates: Dict[str, float] = roofline.PEAKS) -> List[Dict]:
    """A recording's rows summed by the kernel they ran (the expert-batched
    launches with their 2-D kernel, whose device functions they share),
    each beside its device time, bound and share."""
    by: Dict[str, Dict] = {}
    for op, r in snapshot.items():
        if r.get("kernel") is None:
            continue
        k = r["kernel"].replace("_batched", "")
        row = by.setdefault(k, {"kernel": k, "sites": [], "calls": 0,
                                "bytes": 0, "flops": 0, "peak": None})
        row["sites"].append(op)
        row["calls"] += r["calls"]
        row["bytes"] += r["bytes"]
        row["flops"] += r["flops"]
        row["peak"] = row["peak"] or r.get("peak")
    out = []
    for k in sorted(by):
        row = by[k]
        row["bound_ms"], row["bound_by"] = roofline.kernel_bound(
            row["flops"], row["bytes"], row["peak"] or "bf16", rates)
        row["device_ms"] = device_ms.get(k)
        row["share"] = (row["bound_ms"] / row["device_ms"]
                        if row["device_ms"] else None)
        out.append(row)
    return out


def kernel_table(snapshot: Dict[str, Dict], device_ms: Dict[str, float],
                 rates: Dict[str, float] = roofline.PEAKS) -> str:
    lines = [
        "| kernel | sites | calls | device ms | GB | GFLOP | bound ms | "
        "share | bound by |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in kernel_rows(snapshot, device_ms, rates):
        by = r["bound_by"] + (f" ({r['peak']} peak)"
                              if r["bound_by"] == "operations" else "")
        lines.append(
            f"| {r['kernel']} | {', '.join(r['sites'])} | {r['calls']} | "
            f"{_f(r['device_ms'], '.3f')} | {r['bytes'] / 1e9:.3f} | "
            f"{r['flops'] / 1e9:.1f} | {r['bound_ms']:.3f} | "
            f"{_f(r['share'], '.3f')} | {by} |")
    return "\n".join(lines)


def compare(base_rows: List[Dict], new_rows: List[Dict]) -> str:
    """The steps present in both: measured ms, MFU and share, base beside
    new."""
    base = {r["name"]: r for r in base_rows}
    lines = ["| step | term | base | new | Δ |", "|---|---|---|---|---|"]
    for r in new_rows:
        b = base.get(r["name"])
        if b is None:
            continue
        for term, scale in (("measured_s", 1e3), ("mfu", 1.0),
                            ("share", 1.0)):
            x, y = b[term] * scale, r[term] * scale
            delta = f"{(y - x) / x:+.1%}" if x else "—"
            lines.append(f"| {r['name']} | {term.replace('_s', ' ms')} | "
                         f"{x:.4g} | {y:.4g} | {delta} |")
    return "\n".join(lines)


def dryrun_table(directory: str) -> str:
    """The dry run's artifacts in ``directory`` (one mesh's), as a
    markdown table: analytic FLOPs and bytes a chip, the analytic
    collective bytes a rank, the argument bytes a rank."""
    lines = [
        "| arch × cell | kind | FLOPs/chip (analytic) | bytes/chip "
        "(analytic) | collective GB/rank (analytic) | argument GiB/rank | "
        "status |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, art in roofline.load_artifacts(directory).items():
        if not art.get("ok"):
            lines.append(f"| {key} | — | — | — | — | — | FAILED: "
                         f"{str(art.get('error', ''))[-40:]} |")
            continue
        cost = art.get("cost_analysis", {})
        coll = (art.get("collectives") or {}).get("total") or {}
        arg = art.get("memory_analysis", {}).get("argument_size_in_bytes", 0)
        lines.append(
            f"| {key} | {art.get('kind', '?')} "
            f"| {cost.get('flops', 0):.2e} "
            f"| {cost.get('bytes accessed', 0):.2e} "
            f"| {(coll.get('bytes') or 0) / 1e9:.2f} "
            f"| {arg / 2 ** 30:.2f} | ok |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?",
                    help="JSON with 'roofline' and/or 'kernels'")
    ap.add_argument("--base", help="a second such file to compare against")
    ap.add_argument("--dryrun", help="a directory of one mesh's dry-run "
                    "artifacts (launch/dryrun.py)")
    args = ap.parse_args(argv)
    if args.dryrun:
        print("## Dry run\n")
        print(dryrun_table(args.dryrun))
        print("\n## Roofline of the dry run\n")
        print(roofline.table(args.dryrun))
    if not args.rows:
        return 0
    with open(args.rows) as f:
        doc = json.load(f)
    if doc.get("roofline"):
        print("## Roofline\n")
        print(roofline_table(doc["roofline"]))
    for title, k in doc.get("kernels", {}).items():
        print(f"\n## Kernels: {title}\n")
        print(kernel_table(k["snapshot"], k["device_ms"]))
    if args.base:
        with open(args.base) as f:
            base = json.load(f)
        print("\n## Base against new\n")
        print(compare(base.get("roofline", []), doc.get("roofline", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
