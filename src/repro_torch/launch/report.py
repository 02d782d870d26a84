"""Render the §Dry-run and §Roofline markdown tables from the dry-run
record directory (``launch.dryrun``), the counterpart of
``repro.launch.report``.

    python -m repro_torch.launch.report [--dir experiments/dryrun]

The text is the reference's on the same records, but for the fits column,
which names the records' HBM (``hbm_bytes``: 80 GB on the H100; the
reference's TPU records carry none and read 16 GB).  The numbers are
accounting on the card's data-sheet figures, not timings.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(n) -> str:
    if n is None:
        return "—"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def fmt_s(x) -> str:
    if x is None:
        return "—"
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1.0:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def hbm_gb(recs: list[dict]) -> int:
    """The records' HBM in the fits column's units: decimal GB for a record
    that names it, 16 (the reference's 16 GiB chip) for one that does not."""
    hbm = next((r["hbm_bytes"] for r in recs if "hbm_bytes" in r), None)
    return 16 if hbm is None else round(hbm / 1e9)


def dryrun_table(recs: list[dict]) -> str:
    rows = [
        f"| arch | shape | mesh | status | per-dev HBM | fits {hbm_gb(recs)}G | compile "
        "| collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        mesh = {"pod": "16x16", "multipod": "2x16x16"}.get(r.get("mesh_kind", ""), "?")
        if r.get("status") == "skip":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | **skip** | — | — | — | "
                f"{r['skip_reason'][:70]}… |"
            )
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | {r['status']} | — | — | — | — |")
            continue
        mem = r.get("memory") or {}
        peak = mem.get("peak_bytes")
        colls = r.get("collectives_by_kind") or {}
        coll_str = (
            ", ".join(f"{k.split('-')[-1][:6]}:{fmt_bytes(v)}" for k, v in sorted(colls.items()))
            or "none"
        )
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | ok | {fmt_bytes(peak)} "
            f"({r.get('hbm_util', 0):.2f}x) | {'yes' if r.get('fits_hbm') else 'NO'} | "
            f"{r.get('compile_s', 0):.0f}s | {coll_str} |"
        )
    return "\n".join(rows)


def roofline_table(recs: list[dict], mesh_kind: str = "pod") -> str:
    rows = [
        "| arch | shape | compute | memory(floor) | collective | dominant | "
        "MODEL/HLO flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or r.get("mesh_kind") != mesh_kind:
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r.get('memory_floor_s'))} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{100 * (r.get('useful_flops_ratio') or 0):.0f}% | "
            f"**{100 * (r.get('roofline_fraction') or 0):.1f}%** |"
        )
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    recs = load(args.dir)
    ok = sum(1 for r in recs if r.get("status") == "ok")
    skip = sum(1 for r in recs if r.get("status") == "skip")
    print(f"### §Dry-run ({ok} compiled cells, {skip} assigned skips)\n")
    print(dryrun_table(recs))
    print("\n### §Roofline — single pod (16x16 = 256 chips)\n")
    print(roofline_table(recs, "pod"))
    print("\n### §Roofline — multi-pod (2x16x16 = 512 chips)\n")
    print(roofline_table(recs, "multipod"))


if __name__ == "__main__":
    main()
