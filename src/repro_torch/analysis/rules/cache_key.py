"""R-CACHE — cache-key completeness, over the port's `search/cache.py`.

Three checks:

1. **Field coverage.**  Every dataclass field of `Workload` /
   `HardwareDesc` / `MapperConfig` that scoring code reads
   (`core/evaluator.py`, `core/backend.py`, `core/mapspace_array.py`,
   `core/mapper.py`) must be reachable from the `cache_key` payload in
   `search/cache.py` — either read explicitly inside the class's sig
   helper or swept in via `dataclasses.asdict`.  A field that steers
   scoring but not the key silently poisons the cache (CACHE_FORMAT has
   been bumped three times for this bug class).  `ConstraintSet` is
   checked the same way against its own `signature()`.  Exemptions
   (cosmetic identity fields, excluded *on purpose* so
   identically-parameterized designs share entries) are listed in
   `EXEMPT` with rationale — not in the baseline.

2. **Schema pinning.**  The *shape* of the key payload (payload dict
   keys, per-sig covered fields, `Level` field list, constraint
   signature keys) is hashed and pinned in `cache_key_schema.json`
   alongside the `CACHE_FORMAT` it was pinned under.  Changing the
   shape without bumping `CACHE_FORMAT` is an error; after a bump,
   `python -m repro_torch.analysis --update-schema` re-pins (and refuses
   to re-pin over a shape change that didn't bump the format).  The pin
   is the port's own (`src/repro_torch/analysis/cache_key_schema.json`),
   written under the port's `CACHE_FORMAT`.

3. **The port's key components.**  The port keys every entry on the
   resolved scoring engine (`backend`: "torch" or "cuda", never the JAX
   package's "jnp"/"pallas") and, on the packed paths, on the mapspace
   digest (its per-arch search builds packed mapspaces, so its per-arch
   keys carry the digest too).  `REQUIRED_PAYLOAD_KEYS` must stay among
   the payload keys: a key without the engine would let torch- and
   cuda-scored winners alias, and one without the digest would trust the
   mapper config to describe the scored candidates.
"""
from __future__ import annotations

import ast
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from ..engine import SRC_REL, Finding, RepoIndex
from . import register_rule

CACHE_MOD = "search/cache.py"
CONSTRAINTS_MOD = "search/constraints.py"

#: tracked dataclasses: class -> (defining module, sig-param alias hints)
TRACKED = {
    "Workload": ("core/workload.py", {"wl", "workload", "w"}),
    "HardwareDesc": ("core/designer.py", {"hw", "hardware", "hwd"}),
    "MapperConfig": ("core/mapper.py", {"cfg", "config", "mapper_cfg"}),
    "MixDesc": ("core/scheduler.py", {"mix", "mix_desc", "mixdesc"}),
}

#: modules whose attribute reads count as "scoring consumes this field"
CONSUMERS = ("core/evaluator.py", "core/backend.py",
             "core/mapspace_array.py", "core/mapper.py",
             "core/scheduler.py")

#: deliberate key exclusions, with rationale (documented, not baselined)
EXEMPT: Dict[str, Dict[str, str]] = {
    "Workload": {
        "name": "identity label; same-shape layers share cache entries "
                "by design (see _workload_sig)",
        "layer": "provenance bookkeeping, never read by scoring",
        "phase": "provenance bookkeeping; FW/BW/WG shapes differ in dims",
    },
    "HardwareDesc": {
        "name": "cosmetic; identically-parameterized designs share "
                "entries (see _hw_sig)",
    },
    "MapperConfig": {},
    "MixDesc": {
        "name": "cosmetic, like HardwareDesc.name; mix identity is the "
                "members tuple (see _mix_sig)",
    },
}

#: payload keys the port's cache key must carry (check 3 above)
REQUIRED_PAYLOAD_KEYS = ("backend", "mapspace")

SCHEMA_FILE = Path(__file__).resolve().parents[1] / "cache_key_schema.json"


# ---------------------------------------------------------------------------
# schema extraction (pure AST)
# ---------------------------------------------------------------------------
def _cache_format(index: RepoIndex) -> Optional[int]:
    mod = index.get(CACHE_MOD)
    if mod is None:
        return None
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "CACHE_FORMAT" and \
                        isinstance(node.value, ast.Constant):
                    return int(node.value.value)
    return None


def _payload_dict(index: RepoIndex) -> Tuple[List[str], Dict[str, ast.Call]]:
    """Static payload keys of ``cache_key`` plus, per key, the sig-helper
    call producing its value (when it is one).  Conditional
    ``payload["k"] = ...`` subscript assignments count as keys too."""
    mod = index.get(CACHE_MOD)
    keys: List[str] = []
    sig_calls: Dict[str, ast.Call] = {}
    if mod is None or "cache_key" not in mod.functions:
        return keys, sig_calls
    fn = mod.functions["cache_key"]
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "payload" and \
                    isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant):
                        keys.append(str(k.value))
                        if isinstance(v, ast.Call):
                            sig_calls[str(k.value)] = v
            elif isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "payload" and \
                    isinstance(t.slice, ast.Constant):
                keys.append(str(t.slice.value))
    return keys, sig_calls


def _sig_coverage(index: RepoIndex) -> Dict[str, Set[str]]:
    """class name -> fields covered by its sig helper in search/cache.py
    (explicit ``param.field`` reads; ``dataclasses.asdict(param)`` sweeps
    in every declared field)."""
    mod = index.get(CACHE_MOD)
    covered: Dict[str, Set[str]] = {}
    if mod is None:
        return covered
    for qual, fn in mod.functions.items():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.args.args:
            continue
        arg = fn.args.args[0]
        cls = _annotation_class(arg.annotation)
        if cls not in TRACKED:
            continue
        relpath = TRACKED[cls][0]
        fields = set(index.dataclass_fields(relpath, cls))
        got = covered.setdefault(cls, set())
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == arg.arg and node.attr in fields:
                got.add(node.attr)
            if isinstance(node, ast.Call):
                target = index.resolve_call(mod, node)
                if target and target.endswith("asdict") and node.args and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id == arg.arg:
                    got |= fields
    return covered


def _annotation_class(ann: Optional[ast.AST]) -> Optional[str]:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1]
    return None


def _signature_keys(index: RepoIndex, relpath: str,
                    qual: str) -> List[str]:
    """Static keys of the dict returned by ``<qual>`` (e.g.
    ``ConstraintSet.signature``)."""
    mod = index.get(relpath)
    if mod is None or qual not in mod.functions:
        return []
    keys: Set[str] = set()
    for node in ast.walk(mod.functions[qual]):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant):
                    keys.add(str(k.value))
    return sorted(keys)


def _init_attrs(index: RepoIndex, relpath: str, cls: str) -> List[str]:
    """``self.X = ...`` targets in ``cls.__init__`` (public only)."""
    mod = index.get(relpath)
    if mod is None:
        return []
    fn = mod.functions.get(f"{cls}.__init__")
    if fn is None:
        return []
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and not t.attr.startswith("_"):
                    out.add(t.attr)
    return sorted(out)


def compute_key_schema(index: RepoIndex) -> Dict[str, Any]:
    """The cache-key payload *shape*: everything whose change alters what
    the key hashes, independent of any concrete query.  Used both by the
    schema-pin check here and by tests/test_cache.py (tier-1)."""
    keys, _ = _payload_dict(index)
    coverage = _sig_coverage(index)
    return {
        "payload_keys": sorted(keys),
        "sig_fields": {cls: sorted(fields)
                       for cls, fields in sorted(coverage.items())},
        # Level rides into the key wholesale via asdict(lv) in _hw_sig:
        # adding a Level field changes key content, so it is part of the
        # shape even though Level itself is not a tracked class.
        "level_fields": sorted(
            index.dataclass_fields("core/designer.py", "Level")),
        "constraint_signature_keys": _signature_keys(
            index, CONSTRAINTS_MOD, "Constraint.signature"),
        "constraint_set_signature_keys": _signature_keys(
            index, CONSTRAINTS_MOD, "ConstraintSet.signature"),
    }


def schema_hash(schema: Dict[str, Any]) -> str:
    blob = json.dumps(schema, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def pin_path(index: RepoIndex) -> Path:
    """The pin lives in the *analyzed* tree (so copied/mutated trees are
    checked against their own pin), not the running analyzer's."""
    return index.root / SRC_REL / "analysis" / "cache_key_schema.json"


def load_pin(path: Path = SCHEMA_FILE) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(path.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def write_pin(index: RepoIndex, path: Path = SCHEMA_FILE,
              force: bool = False) -> str:
    """Re-pin the schema.  Refuses to pin a *shape change* under an
    unchanged CACHE_FORMAT unless ``force`` — the whole point is that a
    shape change implies a format bump."""
    fmt = _cache_format(index)
    cur = schema_hash(compute_key_schema(index))
    pin = load_pin(path)
    if pin and not force and cur != pin.get("schema_hash") and \
            fmt == pin.get("cache_format"):
        raise RuntimeError(
            "cache_key payload shape changed but CACHE_FORMAT is still "
            f"{fmt}; bump CACHE_FORMAT in src/repro_torch/{CACHE_MOD} first, "
            "then re-run --update-schema")
    path.write_text(json.dumps(
        {"_comment": "machine-written by `python -m repro_torch.analysis "
                     "--update-schema`; do not edit by hand",
         "cache_format": fmt, "schema_hash": cur},
        indent=1, sort_keys=True) + "\n")
    return cur


# ---------------------------------------------------------------------------
# consumer-side attribute reads
# ---------------------------------------------------------------------------
def _base_hint(node: ast.Attribute) -> Optional[str]:
    if isinstance(node.value, ast.Name):
        return node.value.id
    if isinstance(node.value, ast.Attribute):
        return node.value.attr
    return None


def _consumer_reads(index: RepoIndex) -> Dict[str, List[Tuple[str, Any]]]:
    """field reads attributed to tracked classes:
    ``cls -> [(field, (module, node)), ...]``.  A read of field ``f``
    counts for class C when ``f`` is one of C's declared fields and the
    receiver name matches C's alias hints — or ``f`` is unique to C among
    the tracked classes.  Ambiguous reads with no matching hint count
    against every candidate (conservative)."""
    fields = {cls: set(index.dataclass_fields(rel, cls))
              for cls, (rel, _) in TRACKED.items()}
    hints = {cls: aliases for cls, (_, aliases) in TRACKED.items()}
    reads: Dict[str, List[Tuple[str, Any]]] = {cls: [] for cls in TRACKED}
    for rel in CONSUMERS:
        mod = index.get(rel)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute) or \
                    not isinstance(node.ctx, ast.Load):
                continue
            cands = [c for c in TRACKED if node.attr in fields[c]]
            if not cands:
                continue
            if len(cands) > 1:
                base = _base_hint(node)
                hinted = [c for c in cands if base in hints[c]]
                cands = hinted or cands
            for c in cands:
                reads[c].append((node.attr, (mod, node)))
    return reads


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
@register_rule
class CacheKeyRule:
    id = "R-CACHE"
    name = "cache-key-completeness"
    description = ("scoring-relevant dataclass fields must be covered by "
                   "the result-cache key, and key-shape changes must bump "
                   "CACHE_FORMAT (pinned schema hash)")

    def run(self, index: RepoIndex) -> List[Finding]:
        if index.get(CACHE_MOD) is None:
            return []                       # fixture tree without a cache
        out: List[Finding] = []
        out += self._field_coverage(index)
        out += self._required_keys(index)
        out += self._constraint_set(index)
        out += self._schema_pin(index)
        return out

    def _field_coverage(self, index: RepoIndex) -> List[Finding]:
        out: List[Finding] = []
        covered = _sig_coverage(index)
        keys, sig_calls = _payload_dict(index)
        reads = _consumer_reads(index)
        for cls, cls_reads in reads.items():
            cov = covered.get(cls, set())
            exempt = EXEMPT.get(cls, {})
            seen: Set[str] = set()
            for field, (mod, node) in cls_reads:
                if field in cov or field in exempt or field in seen:
                    continue
                seen.add(field)
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=node.lineno, col=node.col_offset,
                    message=(f"{cls}.{field} is read by scoring code but "
                             f"not covered by the cache key (add it to "
                             f"the {cls} sig in src/repro_torch/{CACHE_MOD}, "
                             f"or list it in R-CACHE EXEMPT with a "
                             f"rationale)"),
                    symbol=mod.enclosing_function(node) or ""))
            if cov and not keys:
                out.append(Finding(
                    rule=self.id, path=f"src/repro_torch/{CACHE_MOD}", line=1,
                    col=0, message="cache_key has no payload dict"))
        return out

    def _required_keys(self, index: RepoIndex) -> List[Finding]:
        keys, _ = _payload_dict(index)
        if not keys:
            return []                   # reported by _field_coverage
        return [Finding(
            rule=self.id, path=f"src/repro_torch/{CACHE_MOD}", line=1,
            col=0, symbol="cache_key",
            message=(f"cache_key payload lacks {k!r} — the port keys "
                     f"every entry on the resolved engine and the "
                     f"mapspace digest, or torch/cuda and packed/"
                     f"unpacked winners alias"))
            for k in REQUIRED_PAYLOAD_KEYS if k not in keys]

    def _constraint_set(self, index: RepoIndex) -> List[Finding]:
        out: List[Finding] = []
        mod = index.get(CONSTRAINTS_MOD)
        if mod is None:
            return out
        sig_keys = set(_signature_keys(index, CONSTRAINTS_MOD,
                                       "ConstraintSet.signature"))
        if not sig_keys:
            return out
        for attr in _init_attrs(index, CONSTRAINTS_MOD, "ConstraintSet"):
            if attr not in sig_keys:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=mod.functions["ConstraintSet.__init__"].lineno,
                    col=0,
                    message=(f"ConstraintSet.{attr} is set in __init__ "
                             f"but missing from signature()/digest() — "
                             f"constrained runs with different {attr} "
                             f"would alias in the cache"),
                    symbol="ConstraintSet.__init__"))
        return out

    def _schema_pin(self, index: RepoIndex) -> List[Finding]:
        ppath = pin_path(index)
        if not ppath.parent.is_dir():
            return []                   # fixture tree without the analyzer
        fmt = _cache_format(index)
        cur = schema_hash(compute_key_schema(index))
        pin = load_pin(ppath)
        loc = dict(rule=self.id, path=f"src/repro_torch/{CACHE_MOD}", line=1,
                   col=0, symbol="cache_key")
        if pin is None:
            return [Finding(message=(
                "cache-key schema pin missing: run `python -m "
                "repro_torch.analysis --update-schema`"), **loc)]
        if cur != pin.get("schema_hash"):
            if fmt == pin.get("cache_format"):
                return [Finding(message=(
                    f"cache_key payload schema changed but CACHE_FORMAT "
                    f"is still {fmt} — stale cache entries would alias "
                    f"new-scheme keys; bump CACHE_FORMAT, then run "
                    f"`python -m repro_torch.analysis "
                    f"--update-schema`"), **loc)]
            return [Finding(message=(
                "cache-key schema pin is stale (CACHE_FORMAT was bumped): "
                "run `python -m repro_torch.analysis "
                "--update-schema`"), **loc)]
        if fmt != pin.get("cache_format"):
            return [Finding(message=(
                f"CACHE_FORMAT is {fmt} but the schema pin was written "
                f"under {pin.get('cache_format')}: run `python -m "
                f"repro_torch.analysis --update-schema`"), **loc)]
        return []
