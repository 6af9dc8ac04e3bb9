"""trimlint CLI for the PyTorch port.

    python -m repro_torch.analysis                  # text report
    python -m repro_torch.analysis --strict --format sarif --output o.sarif
    python -m repro_torch.analysis --update-schema  # re-pin cache-key schema
    python -m repro_torch.analysis --write-baseline # grandfather findings

Exit codes: 0 clean; 1 fresh findings (always) or stale baseline
entries (``--strict`` only); 2 usage errors.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from . import baseline as baseline_mod
from . import output
from .engine import build_index, find_root
from .rules import get_rules
from .rules.cache_key import pin_path, write_pin


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="trimlint: repo-aware static analysis for the "
                    "PyTorch port of the TRIM reproduction (rules: "
                    "docs/static-analysis.md; the port's differences: "
                    "README.md)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--output", default=None,
                    help="write the report to a file instead of stdout")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/"
                         f"{baseline_mod.DEFAULT_NAME})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries (CI mode)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather all current findings into the "
                         "baseline and exit")
    ap.add_argument("--update-schema", action="store_true",
                    help="re-pin the cache-key schema hash (refuses a "
                         "shape change without a CACHE_FORMAT bump)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    try:
        rules = get_rules(args.rules.split(",") if args.rules else None)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    if args.list_rules:
        for r in rules:
            print(f"{r.id:10s} {r.name}: {r.description}")
        return 0

    try:
        root = find_root(Path(args.root) if args.root else Path.cwd())
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    index = build_index(root)

    if args.update_schema:
        try:
            digest = write_pin(index, pin_path(index))
        except RuntimeError as e:
            print(f"trimlint: {e}", file=sys.stderr)
            return 2
        print(f"pinned cache-key schema {digest[:16]}… "
              f"-> {pin_path(index)}")
        return 0

    findings = []
    for rule in rules:
        findings.extend(rule.run(index))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))

    bl_path = Path(args.baseline) if args.baseline else \
        baseline_mod.default_path(root)
    if args.write_baseline:
        baseline_mod.write(bl_path, findings)
        print(f"wrote {len(findings)} finding(s) to {bl_path}")
        return 0
    bl = baseline_mod.load(bl_path)
    fresh, suppressed, stale = baseline_mod.apply(findings, bl)

    if args.format == "text":
        report = output.format_text(fresh, suppressed, stale)
    elif args.format == "json":
        report = output.to_json(fresh, suppressed, stale)
    else:
        report = output.to_sarif(fresh, rules)
    if args.output:
        Path(args.output).write_text(report + "\n")
        print(f"trimlint: {len(fresh)} finding(s) -> {args.output}")
    else:
        print(report)

    if fresh:
        return 1
    if args.strict and stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
