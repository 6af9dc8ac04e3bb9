"""Baseline handling: grandfathered findings, keyed by fingerprint.

The baseline file is a checked-in JSON list of finding fingerprints
(plus human-readable context).  Findings whose fingerprint appears are
*suppressed* — reported separately, never failing the run.  A baseline
entry with no live finding is *stale* and fails ``--strict`` runs, so
entries expire the moment the underlying issue is fixed (baselines only
shrink; new debt can't hide behind old).

The port's baseline (`trimlint-torch-baseline.json`, beside the JAX
package's `trimlint-baseline.json`) ships **empty**: all true positives
at HEAD are fixed, not grandfathered.  `--write-baseline` exists for
adopting the linter elsewhere / staging large refactors.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

from .engine import Finding

BASELINE_VERSION = 1
DEFAULT_NAME = "trimlint-torch-baseline.json"


def default_path(root: Path) -> Path:
    return Path(root) / DEFAULT_NAME


def load(path: Path) -> Dict[str, Dict[str, Any]]:
    """fingerprint -> entry; {} for a missing file."""
    try:
        data = json.loads(Path(path).read_text())
    except FileNotFoundError:
        return {}
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write(path: Path, findings: List[Finding]) -> None:
    entries = [{"fingerprint": f.fingerprint(), "rule": f.rule,
                "path": f.path, "message": f.message, "symbol": f.symbol}
               for f in sorted(findings,
                               key=lambda f: (f.rule, f.path, f.message))]
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": entries},
        indent=1, sort_keys=True) + "\n")


def apply(findings: List[Finding], baseline: Dict[str, Dict[str, Any]],
          ) -> Tuple[List[Finding], List[Finding],
                     List[Dict[str, Any]]]:
    """-> (fresh, suppressed, stale-baseline-entries)."""
    fresh, suppressed = [], []
    live = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in baseline:
            suppressed.append(f)
            live.add(fp)
        else:
            fresh.append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in live]
    return fresh, suppressed, stale
