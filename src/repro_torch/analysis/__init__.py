"""repro_torch.analysis — trimlint for the PyTorch port.

The JAX package's analyzer (`repro.analysis`) holds `src/repro` to
invariants no unit test can see syntactically; this copy holds
`src/repro_torch` to the same ones:

  * the content-addressed result-cache key must cover every input that
    affects scoring, and a change of its shape must bump CACHE_FORMAT
    (pinned in this package's own `cache_key_schema.json`) — R-CACHE;
  * host<->device sync points (`.item()` / `.cpu()` / `.numpy()` /
    `float()` / `np.asarray` / `torch.cuda.synchronize()` on values that
    torch calls produced) must stay inside trace spans so phase
    attribution stays honest — R-SYNC;
  * scoring, digest, and strategy ask/tell paths must be deterministic
    for warm-cache replay — R-DET;
  * spans open only via context manager and driver phases come from one
    canonical tuple — R-TRACE;
  * the strategy registry and ProgressEvent kinds stay covered by their
    contract test / console sink — R-REG.

`engine.build_index` walks `src/repro_torch` (plus `tests/`) into a light
module/function/call index; rules under `rules/` consume it and return
`Finding`s.  Everything is stdlib-only (`ast`, `json`, `pathlib`): the
pass imports neither torch nor the JAX package, and runs on a bare
Python install.

    python -m repro_torch.analysis --strict --format sarif

docs/static-analysis.md describes the rules and the baseline workflow;
README.md's port section lists where this copy differs (R-SYNC's torch
device sources, forcing points and barriers).  The port's baseline is
`trimlint-torch-baseline.json`.
"""
from .engine import (Finding, Module, RepoIndex, build_index, find_root,
                     run_analysis)
from .rules import RULES, get_rules

__all__ = ["Finding", "Module", "RepoIndex", "build_index", "find_root",
           "run_analysis", "RULES", "get_rules"]
