"""Run manifests: one JSON record per `run_search` describing exactly
what ran — enough to attribute any cached result or benchmark number to
the code, space, constraints, and phase costs that produced it.

Written alongside the cached results (`<cache_dir>/manifests/` — a
subdirectory so the cache GC, which only sweeps `*.json` entries in the
cache root, never evicts provenance), and also exportable anywhere via
`RunManifest.write(path)`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

import torch

MANIFEST_VERSION = 1
MANIFEST_DIR = "manifests"


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort commit sha of the working tree (None outside a repo)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd or os.path.dirname(
                os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def space_digest(space) -> str:
    """Content hash of an ArchSpace lattice (axis names + values)."""
    payload = {"axes": {n: [str(v) for v in vals]
                        for n, vals in zip(space.axis_names,
                                           space.axis_values)}}
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class RunManifest:
    """Provenance + phase accounting for one search run."""
    run_id: str
    created_unix: float
    git_sha: Optional[str]
    device: Optional[str]                # torch device the run scored on
    device_name: Optional[str]           # the card's name (None on a CPU)
    compute_capability: Optional[str]    # "major.minor" (None on a CPU)
    backend: str                         # resolved scoring engine
    strategy: str
    goal: str
    budget: int
    space_size: int
    space_digest: str
    constraints: Optional[str]           # human-readable
    constraints_digest: Optional[str]
    counters: Dict[str, Any]             # n_evaluated / cache stats / ...
    wall_time_s: float
    phase_times: Dict[str, float]        # seconds by driver phase
    best_arch: Optional[str]
    best_value: Optional[float]
    version: int = MANIFEST_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def write(self, directory: str) -> str:
        """Write `<directory>/<run_id>.json` (atomic rename)."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.run_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True,
                      default=str)
        os.replace(tmp, path)
        return path

    @staticmethod
    def read(path: str) -> "RunManifest":
        with open(path) as f:
            d = json.load(f)
        d.pop("version", None)
        return RunManifest(version=MANIFEST_VERSION, **d)


def device_fields(device) -> Dict[str, Optional[str]]:
    """The run's torch device, and for a CUDA device the card's name and
    compute capability."""
    if device is None:
        return {"device": None, "device_name": None,
                "compute_capability": None}
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": str(dev), "device_name": None,
                "compute_capability": None}
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return {"device": f"cuda:{index}",
            "device_name": torch.cuda.get_device_name(index),
            "compute_capability": f"{major}.{minor}"}


def build_manifest(report, space, *, wall_time_s: float,
                   tracer=None, device=None) -> RunManifest:
    """Assemble a manifest from a finished `SearchReport`; `device` is the
    torch device the run scored on."""
    sd = space_digest(space)
    cdig = report.constraints.digest() if report.constraints else None
    created = time.time()
    rid_blob = json.dumps([sd, cdig, report.strategy, report.goal,
                           report.backend, created], default=str)
    run_id = "run-" + hashlib.sha256(rid_blob.encode()).hexdigest()[:16]
    counters = {
        "n_evaluated": report.n_evaluated,
        "n_revisits": report.n_revisits,
        "n_enumerations": report.n_enumerations,
        "n_cache_hits": report.n_cache_hits,
        "n_cache_misses": report.n_cache_misses,
        "n_packed_builds": report.n_packed_builds,
        "n_feasible": report.n_feasible,
        "n_skipped_infeasible": report.n_skipped_infeasible,
        "cache": report.cache_stats,
    }
    return RunManifest(
        run_id=run_id, created_unix=created, git_sha=git_sha(),
        **device_fields(device), backend=report.backend,
        strategy=report.strategy,
        goal=report.goal, budget=report.budget,
        space_size=report.space_size, space_digest=sd,
        constraints=str(report.constraints) if report.constraints else None,
        constraints_digest=cdig, counters=counters,
        wall_time_s=wall_time_s,
        phase_times=(tracer.phase_times() if tracer is not None
                     and getattr(tracer, "enabled", False) else {}),
        best_arch=(report.best.hardware.name if report.best else None),
        best_value=(report.goal_value() if report.best else None))
