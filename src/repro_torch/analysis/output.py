"""Output formats: text (human), JSON (tooling), SARIF 2.1.0 (CI code
scanning).  All three carry the same findings; SARIF additionally
carries the rule catalog and per-result partial fingerprints so GitHub
code-scanning dedup matches the baseline's identity."""
from __future__ import annotations

import json
from typing import Any, Dict, List

from .engine import Finding

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def format_text(fresh: List[Finding], suppressed: List[Finding],
                stale: List[Dict[str, Any]]) -> str:
    lines = [f.render() for f in fresh]
    if suppressed:
        lines.append(f"-- {len(suppressed)} finding(s) suppressed by "
                     f"baseline")
    for e in stale:
        lines.append(f"-- stale baseline entry {e['fingerprint']} "
                     f"({e['rule']} {e['path']}): issue no longer "
                     f"present, remove it")
    n = len(fresh)
    lines.append(f"trimlint: {n} finding(s)" if n else "trimlint: clean")
    return "\n".join(lines)


def to_json(fresh: List[Finding], suppressed: List[Finding],
            stale: List[Dict[str, Any]]) -> str:
    return json.dumps({
        "version": 1,
        "findings": [f.to_dict() for f in fresh],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_baseline": stale,
    }, indent=1, sort_keys=True)


def to_sarif(fresh: List[Finding], rules: List[Any]) -> str:
    results = []
    for f in fresh:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": max(1, f.col + 1)},
                },
            }],
            "partialFingerprints": {"trimlint/v1": f.fingerprint()},
        })
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "trimlint",
                "informationUri":
                    "docs/static-analysis.md",
                "rules": [{
                    "id": r.id,
                    "name": r.name,
                    "shortDescription": {"text": r.description},
                } for r in rules],
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=1, sort_keys=True)
