"""R-REG — registry coverage.

Registries rot silently: a new `@register("...")` strategy that the
contract test never exercises, or a new ProgressEvent kind the console
sink doesn't know, both pass every existing test.  This rule pins the
two registries to their consumers:

  * every strategy name registered in the port's `search/strategies.py`
    must be exercised by `tests/test_torch_strategy_contract.py` —
    satisfied structurally when the test parametrizes (or loops) over
    the port's `STRATEGIES` registry itself (the robust pattern),
    otherwise each name must appear as a literal.  The registry is
    matched by the *origin* of the name the test uses: a port test that
    parametrizes over the JAX package's `repro.search.STRATEGIES` (as
    the parity tests do, to compare the two registries) proves nothing
    about what the port registers, so it does not count;
  * every `ProgressStream.emit("<kind>")` literal in `src/repro_torch` must be
    a declared `EVENT_KINDS` member (typo guard), every declared kind
    must actually be emitted somewhere, and `ConsoleSink` must handle
    every kind — via an explicit `ev.kind == "..."` branch or a generic
    catch-all branch.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import PKG, Finding, Module, RepoIndex
from . import register_rule

STRATEGIES_MOD = "search/strategies.py"
CONTRACT_TEST = "tests/test_torch_strategy_contract.py"
PROGRESS_MOD = "obs/progress.py"


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------
def registered_strategies(index: RepoIndex) -> List[Tuple[str, int]]:
    mod = index.get(STRATEGIES_MOD)
    if mod is None:
        return []
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) or \
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and (
                        (isinstance(dec.func, ast.Name)
                         and dec.func.id == "register")
                        or (isinstance(dec.func, ast.Attribute)
                            and dec.func.attr == "register")):
                    if dec.args and isinstance(dec.args[0], ast.Constant):
                        out.append((str(dec.args[0].value), node.lineno))
    return out


def _origin(test: Module, expr: ast.AST) -> Optional[str]:
    """Dotted origin of a Name/Attribute chain through the test's
    imports ("ts.STRATEGIES" -> "repro_torch.search.STRATEGIES");
    None for a chain whose head is not an imported name."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name) or cur.id not in test.aliases:
        return None
    return ".".join([test.aliases[cur.id]] + parts[::-1])


def _is_port_registry(test: Module, expr: ast.AST) -> bool:
    origin = _origin(test, expr)
    return origin is not None and origin.startswith(PKG + ".") and \
        origin.endswith(".STRATEGIES")


def _drives(test: Module, node: ast.AST) -> bool:
    """``node`` sits in the arguments of a ``*.parametrize(...)`` call or
    in the iterable of a ``for`` loop / comprehension."""
    child = node
    for anc in test.ancestors(node):
        if isinstance(anc, ast.Call) and \
                isinstance(anc.func, ast.Attribute) and \
                anc.func.attr == "parametrize":
            return True
        if isinstance(anc, (ast.For, ast.comprehension)) and \
                child is anc.iter:
            return True
        child = anc
    return False


def _test_covers_registry(test: Module) -> bool:
    """True when the contract test parametrizes or loops over the port's
    STRATEGIES registry itself — then any registered name is covered by
    construction.  Module-level names bound from the registry
    (``ALL = sorted(STRATEGIES)``) count where they drive a parametrize
    or a loop."""
    bound: Set[str] = set()
    for node in test.tree.body:
        if isinstance(node, ast.Assign) and any(
                _is_port_registry(test, n) for n in ast.walk(node.value)):
            bound.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    for n in ast.walk(test.tree):
        if isinstance(n, ast.Name) and n.id in bound and \
                isinstance(n.ctx, ast.Load) and _drives(test, n):
            return True
        if isinstance(n, (ast.Name, ast.Attribute)) and \
                _is_port_registry(test, n) and _drives(test, n):
            return True
    return False


# ---------------------------------------------------------------------------
# progress events
# ---------------------------------------------------------------------------
def declared_event_kinds(index: RepoIndex) -> Tuple[Tuple[str, ...], int]:
    mod = index.get(PROGRESS_MOD)
    if mod is None:
        return (), 0
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "EVENT_KINDS" and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            kinds = tuple(e.value for e in node.value.elts
                          if isinstance(e, ast.Constant))
            return kinds, node.lineno
    return (), 0


def emitted_kinds(index: RepoIndex) -> List[Tuple[str, Module, ast.Call]]:
    out = []
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "emit" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                out.append((node.args[0].value, mod, node))
    return out


def _console_sink_branches(index: RepoIndex) -> Tuple[Set[str], bool, int]:
    """(kinds with an explicit `ev.kind == "..."` branch, has a generic
    fallback branch, lineno of ConsoleSink.__call__)."""
    mod = index.get(PROGRESS_MOD)
    if mod is None:
        return set(), False, 0
    fn = mod.functions.get("ConsoleSink.__call__")
    if fn is None:
        return set(), False, 0
    explicit: Set[str] = set()
    generic = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            lits = [c.value for c in [node.left] + node.comparators
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)]
            sides = [c for c in [node.left] + node.comparators
                     if isinstance(c, ast.Attribute)
                     and c.attr == "kind"]
            if lits and sides:
                explicit.update(lits)
        if isinstance(node, ast.If):
            # an else: or a test not comparing ev.kind is a catch-all
            if node.orelse and not any(
                    isinstance(n, ast.If) for n in node.orelse):
                generic = True
            if not any(isinstance(n, ast.Attribute) and n.attr == "kind"
                       for n in ast.walk(node.test)):
                generic = True
    return explicit, generic, fn.lineno


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
@register_rule
class RegistryCoverageRule:
    id = "R-REG"
    name = "registry-coverage"
    description = ("every registered strategy is exercised by the "
                   "contract test; ProgressEvent kinds are declared, "
                   "emitted, and handled by ConsoleSink")

    def run(self, index: RepoIndex) -> List[Finding]:
        return self._strategies(index) + self._events(index)

    def _strategies(self, index: RepoIndex) -> List[Finding]:
        regs = registered_strategies(index)
        if not regs:
            return []
        mod = index.get(STRATEGIES_MOD)
        test = index.tests.get(CONTRACT_TEST)
        if test is None:
            return [Finding(
                rule=self.id, path=f"src/repro_torch/{STRATEGIES_MOD}",
                line=regs[0][1], col=0,
                message=(f"{CONTRACT_TEST} is missing — the STRATEGIES "
                         f"registry has no contract coverage"))]
        if _test_covers_registry(test):
            return []
        literals = {n.value for n in ast.walk(test.tree)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
        out = []
        for name, lineno in regs:
            if name not in literals:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod), line=lineno,
                    col=0,
                    message=(f"strategy {name!r} is registered but never "
                             f"exercised by {CONTRACT_TEST} — "
                             f"parametrize the test over STRATEGIES or "
                             f"add the name explicitly"),
                    symbol=name))
        return out

    def _events(self, index: RepoIndex) -> List[Finding]:
        kinds, decl_line = declared_event_kinds(index)
        if not kinds:
            return []
        mod = index.get(PROGRESS_MOD)
        out: List[Finding] = []
        emits = emitted_kinds(index)
        for kind, emod, node in emits:
            if kind not in kinds:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(emod),
                    line=node.lineno, col=node.col_offset,
                    message=(f"emit({kind!r}) is not a declared "
                             f"EVENT_KINDS member — typo, or declare it "
                             f"in src/repro_torch/{PROGRESS_MOD}"),
                    symbol=emod.enclosing_function(node) or ""))
        emitted = {k for k, _, _ in emits}
        for kind in kinds:
            if kind not in emitted:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=decl_line, col=0,
                    message=(f"EVENT_KINDS declares {kind!r} but nothing "
                             f"in src/repro_torch emits it — dead kind, "
                             f"or a missing emit")))
        explicit, generic, sink_line = _console_sink_branches(index)
        if not generic:
            for kind in kinds:
                if kind not in explicit:
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=sink_line, col=0,
                        message=(f"ConsoleSink has no branch for "
                                 f"{kind!r} and no generic fallback — "
                                 f"verbose consumers would silently drop "
                                 f"it"),
                        symbol="ConsoleSink.__call__"))
        return out
