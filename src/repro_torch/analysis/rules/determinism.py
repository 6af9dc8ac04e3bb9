"""R-DET — determinism of the port's scoring, digest, and strategy paths.

Warm-cache replay (tests assert a warm bandit run is bit-identical to a
cold one) and content-addressed caching both die silently if anything
nondeterministic leaks into these paths:

  * **scoring modules** (`core/evaluator.py`, `core/mapper.py`,
    `core/mapspace_array.py`, `core/backend.py`, `core/batch_eval.py`,
    `core/scheduler.py`, and the mapspace kernel's wrapper, job record
    and plain version under `kernels/mapspace_eval/` and the launcher
    they share with the other kernels, `kernels/build.py`, which the
    "cuda" engine scores through):
    no unseeded `np.random.default_rng()` / `random.Random()`, no
    module-level `random.*` draws, no `time.time()` in value position
    (wall-clock reads belong in obs/bench code, not scoring);
  * **strategy module** (`search/strategies.py`): same bans — every
    strategy draws from its seeded `random.Random(seed)`;
  * **digest closures** (everything reachable from `cache_key`,
    `ConstraintSet.digest`, `PackedMapspace.digest`, or the service's
    `SearchQuery.digest` coalescing identity): additionally,
    every `json.dumps` must pass `sort_keys=True` and nothing may
    iterate a `set` (unordered iteration feeding a hash produces
    run-dependent digests).

The cache GC's `time.time()` (lock staleness, mtime eviction) is *not*
in any digest closure and is legitimately wall-clock — scoping the rule
to closures instead of whole modules is what keeps it quiet there.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ..engine import Finding, Module, RepoIndex
from . import register_rule

SCORING_MODULES = ("core/evaluator.py", "core/mapper.py",
                   "core/mapspace_array.py", "core/backend.py",
                   "core/batch_eval.py",
                   # the mix scheduler elects layer->member assignments
                   # on the scoring path: any RNG or wall-clock leak
                   # would make mix winners run-dependent
                   "core/scheduler.py",
                   # the "cuda" engine's scoring path: the kernel's
                   # wrapper, its launcher, its job record and its plain
                   # version
                   "kernels/mapspace_eval/kernel.py", "kernels/build.py",
                   "kernels/mapspace_eval/ops.py",
                   "kernels/mapspace_eval/ref.py")
STRATEGY_MODULES = ("search/strategies.py",)

#: digest closure roots: (module relpath, function qualname)
DIGEST_ROOTS = (("search/cache.py", "cache_key"),
                ("search/constraints.py", "ConstraintSet.digest"),
                ("core/mapspace_array.py", "PackedMapspace.digest"),
                # the mix composition digest partitions the cache
                # namespace per mix — same determinism bar as cache_key
                ("search/cache.py", "mix_digest"),
                # the DSE service's request-coalescing identity: two
                # submits share a job iff these digests are equal, so it
                # is held to the same determinism bar as the cache key
                ("serve/dse_service.py", "SearchQuery.digest"))

UNSEEDED_FACTORIES = {"numpy.random.default_rng", "random.Random"}
GLOBAL_DRAWS = ("numpy.random.", "random.")
GLOBAL_DRAW_OK = {"numpy.random.default_rng", "random.Random",
                  "numpy.random.Generator", "numpy.random.PCG64",
                  "numpy.random.SeedSequence"}
WALLCLOCK = {"time.time", "time.time_ns"}


def _has_seed(call: ast.Call) -> bool:
    """Seeded iff any positional/keyword argument is passed (a literal
    ``None`` seed counts as unseeded)."""
    for a in call.args:
        if not (isinstance(a, ast.Constant) and a.value is None):
            return True
    for kw in call.keywords:
        if not (isinstance(kw.value, ast.Constant)
                and kw.value.value is None):
            return True
    return False


def _closure(index: RepoIndex) -> Set[Tuple[str, str]]:
    """(relpath, qualname) set transitively reachable from DIGEST_ROOTS
    through in-repo calls."""
    fn_table = {}
    for mod in index.modules.values():
        for qual, node in mod.functions.items():
            fn_table[f"{mod.dotted}.{qual}"] = (mod, qual, node)
    seen: Set[str] = set()
    work = []
    for rel, qual in DIGEST_ROOTS:
        mod = index.get(rel)
        if mod is not None and qual in mod.functions:
            work.append(f"{mod.dotted}.{qual}")
    while work:
        dotted = work.pop()
        if dotted in seen or dotted not in fn_table:
            continue
        seen.add(dotted)
        mod, qual, node = fn_table[dotted]
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                target = index.resolve_call(mod, n)
                if target and target in fn_table:
                    work.append(target)
                # `self.signature()` style: resolve within the class
                elif target is None and \
                        isinstance(n.func, ast.Attribute) and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == "self" and "." in qual:
                    cls = qual.split(".")[0]
                    cand = f"{mod.dotted}.{cls}.{n.func.attr}"
                    if cand in fn_table:
                        work.append(cand)
    return {(fn_table[d][0].relpath, fn_table[d][1]) for d in seen}


@register_rule
class DeterminismRule:
    id = "R-DET"
    name = "determinism"
    description = ("no unseeded RNGs, global random draws, or wall-clock "
                   "reads in scoring/strategy paths; digest closures must "
                   "sort json.dumps keys and never iterate sets")

    def run(self, index: RepoIndex) -> List[Finding]:
        out: List[Finding] = []
        for rel in SCORING_MODULES + STRATEGY_MODULES:
            mod = index.get(rel)
            if mod is not None:
                out += self._module_bans(index, mod)
        closure = _closure(index)
        for rel, qual in sorted(closure):
            mod = index.get(rel)
            if mod is not None:
                out += self._digest_bans(index, mod, qual)
        return out

    def _module_bans(self, index: RepoIndex, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            target = index.resolve_call(mod, node)
            if target is None:
                continue
            msg = None
            if target in UNSEEDED_FACTORIES and not _has_seed(node):
                msg = (f"unseeded `{target.split('.')[-1]}()` in a "
                       f"scoring/strategy path — warm-cache replay and "
                       f"mapspace content digests become run-dependent; "
                       f"pass an explicit seed")
            elif target in WALLCLOCK:
                msg = (f"`{target}` in a scoring/strategy path — "
                       f"wall-clock reads belong in obs/bench code, and "
                       f"any value derived from one poisons replay")
            elif any(target.startswith(p) for p in GLOBAL_DRAWS) and \
                    target not in GLOBAL_DRAW_OK:
                msg = (f"global RNG draw `{target}` — draws from the "
                       f"process-global stream are order-dependent "
                       f"across runs; use the seeded generator that the "
                       f"config/strategy already carries")
            if msg:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=node.lineno, col=node.col_offset, message=msg,
                    symbol=mod.enclosing_function(node) or ""))
        return out

    def _digest_bans(self, index: RepoIndex, mod: Module,
                     qual: str) -> List[Finding]:
        out: List[Finding] = []
        fn = mod.functions.get(qual)
        if fn is None:
            return out
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                target = index.resolve_call(mod, node)
                if target == "json.dumps":
                    kw = {k.arg: k.value for k in node.keywords}
                    sk = kw.get("sort_keys")
                    if not (isinstance(sk, ast.Constant) and
                            sk.value is True):
                        out.append(Finding(
                            rule=self.id, path=index.repo_rel(mod),
                            line=node.lineno, col=node.col_offset,
                            message=("`json.dumps` without "
                                     "sort_keys=True inside a digest "
                                     "closure — dict insertion order "
                                     "would leak into the cache key"),
                            symbol=qual))
                elif target in WALLCLOCK or (
                        target in UNSEEDED_FACTORIES
                        and not _has_seed(node)):
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=node.lineno, col=node.col_offset,
                        message=(f"nondeterministic `{target}` inside a "
                                 f"digest closure"),
                        symbol=qual))
            it = None
            if isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
            if it is not None and self._is_set_expr(index, mod, it):
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=getattr(node, "lineno", fn.lineno),
                    col=getattr(node, "col_offset", 0),
                    message=("iteration over a set inside a digest "
                             "closure — unordered iteration feeding a "
                             "hash; sort it first"),
                    symbol=qual))
        return out

    @staticmethod
    def _is_set_expr(index: RepoIndex, mod: Module,
                     expr: ast.AST) -> bool:
        if isinstance(expr, ast.Set) or isinstance(expr, ast.SetComp):
            return True
        if isinstance(expr, ast.Call):
            target = index.resolve_call(mod, expr)
            if target == "set" or (target is None
                                   and isinstance(expr.func, ast.Name)
                                   and expr.func.id in ("set",
                                                        "frozenset")):
                return True
        return False
