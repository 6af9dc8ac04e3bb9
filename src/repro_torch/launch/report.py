"""Dry-run and roofline tables from the per-cell JSON files that
`dryrun.py` writes (the port of the JAX package's `launch/report.py`; the
compile column shows the port's `trace_s`).

    PYTHONPATH=src python -m repro_torch.launch.report \
        --dir experiments/dryrun_torch --out experiments/report_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(dir_: str) -> List[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b):
    if b is None:
        return "-"
    for u in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024:
            return f"{b:.1f}{u}"
        b /= 1024
    return f"{b:.1f}TB"


def dryrun_table(cells: List[dict], mesh: str) -> str:
    rows = ["| arch | shape | compile | HBM/dev (args+temp) | "
            "FLOPs/dev | HLO bytes/dev | collectives (AR/AG/RS/A2A/CP) | "
            "coll. transfer/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP | - | - | - "
                        f"| {c['skipped'][:42]}... | - |")
            continue
        if "error" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | FAIL | - | - | - "
                        f"| {c['error'][:40]} | - |")
            continue
        m = c["memory"]
        co = c["collectives"]["counts"]
        cstr = "/".join(str(co.get(k, 0)) for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['trace_s']:.0f}s "
            f"| {fmt_bytes(m['peak_bytes'])} "
            f"| {c['cost']['flops_per_device']:.2e} "
            f"| {fmt_bytes(c['cost']['bytes_per_device'])} "
            f"| {cstr} "
            f"| {fmt_bytes(c['collectives']['transfer_bytes_per_device'])} |")
    return "\n".join(rows)


def roofline_table(cells: List[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "bottleneck | MODEL_FLOPS | useful ratio | roofline frac | "
            "what would move the dominant term |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | - | - | - | SKIP "
                        f"| - | - | - | sub-quadratic attention required |")
            continue
        if "error" in c:
            continue
        r = c["roofline"]
        hint = _hint(c)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.2e} "
            f"| {r['memory_s']:.2e} | {r['collective_s']:.2e} "
            f"| **{r['bottleneck']}** | {r['model_flops']:.2e} "
            f"| {r['useful_ratio']:.3f} | {r['roofline_fraction']:.3f} "
            f"| {hint} |")
    return "\n".join(rows)


def _hint(c) -> str:
    r = c["roofline"]
    if r["bottleneck"] == "memory":
        if c["shape"].startswith("decode") or c["shape"].startswith("long"):
            return ("decode is weight/KV-streaming bound: quantize KV, "
                    "absorb MLA, or grow per-step batch")
        return ("cut HLO bytes: stronger fusion (flash attention), less "
                "remat traffic, bf16 masters")
    if r["bottleneck"] == "collective":
        return ("overlap/shrink collectives: reduce-scatter grads in bf16/"
                "int8, avoid embedding re-gather")
    return ("raise MODEL/HLO flop ratio: drop remat recompute, pick "
            "cheaper attention lowering")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.report")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/report_torch.md")
    args = ap.parse_args(argv)
    cells = load(args.dir)
    parts = []
    for mesh, title in (("single", "single-pod 16x16 (256 ranks)"),
                        ("multi", "multi-pod 2x16x16 (512 ranks)")):
        parts.append(f"### Dry-run — {title}\n")
        parts.append(dryrun_table(cells, mesh))
        parts.append("")
    parts.append("### Roofline (single-pod, per §Roofline)\n")
    parts.append(roofline_table(cells, "single"))
    txt = "\n".join(parts)
    with open(args.out, "w") as f:
        f.write(txt)
    print(txt[:3000])
    print(f"\n[report] wrote {args.out}")


if __name__ == "__main__":
    main()
