"""R-TRACE — span hygiene.

Two checks over every module in ``src/repro_torch`` (the port's own
``obs/trace.py`` holds the canonical tuple):

1. ``*.span(...)`` is only ever opened as a context manager (a
   ``with``-item, possibly chained/aliased).  A span object that is
   created and never ``__exit__``-ed leaves an open span in the buffer,
   breaks nesting depth for everything after it, and never records a
   duration — there is no legitimate bare call.

2. Spans flagged ``phase=True`` are the driver's non-overlapping
   pipeline accounting (`phase_times()` sums exactly those); their names
   must be string literals drawn from the one canonical
   ``repro_torch.obs.trace.PHASES`` tuple, so a typo'd phase silently
   splitting the accounting ("cache_get" vs "cache-get") is impossible.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..engine import Finding, RepoIndex
from . import register_rule

TRACE_MOD = "obs/trace.py"


def canonical_phases(index: RepoIndex) -> Optional[Tuple[str, ...]]:
    """The PHASES tuple from obs/trace.py, read off the AST (DRIVER_PHASES
    + additions are folded constants there, so evaluate the module's
    top-level tuple assignments)."""
    mod = index.get(TRACE_MOD)
    if mod is None:
        return None
    consts = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            val = _const_tuple(node.value, consts)
            if val is not None:
                consts[name] = val
    return consts.get("PHASES")


def _const_tuple(expr: ast.AST, consts) -> Optional[Tuple[str, ...]]:
    if isinstance(expr, ast.Tuple):
        out = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    if isinstance(expr, ast.Name):
        return consts.get(expr.id)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _const_tuple(expr.left, consts)
        right = _const_tuple(expr.right, consts)
        if left is not None and right is not None:
            return left + right
    return None


@register_rule
class TracingRule:
    id = "R-TRACE"
    name = "span-hygiene"
    description = ("spans open only via `with`; phase=True span names "
                   "must be literals from repro_torch.obs.trace.PHASES")

    def run(self, index: RepoIndex) -> List[Finding]:
        phases = canonical_phases(index)
        out: List[Finding] = []
        for mod in index.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) or \
                        not isinstance(node.func, ast.Attribute) or \
                        node.func.attr != "span":
                    continue
                parent = mod.parents.get(node)
                if not isinstance(parent, ast.withitem):
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=node.lineno, col=node.col_offset,
                        message=("`.span(...)` outside a `with` — a span "
                                 "opened without a context manager never "
                                 "closes and corrupts nesting depth for "
                                 "every span after it"),
                        symbol=mod.enclosing_function(node) or ""))
                    continue
                kw = {k.arg: k.value for k in node.keywords}
                phase = kw.get("phase")
                if phase is None or (isinstance(phase, ast.Constant)
                                     and not phase.value):
                    continue
                name = node.args[0] if node.args else None
                if not (isinstance(name, ast.Constant)
                        and isinstance(name.value, str)):
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=node.lineno, col=node.col_offset,
                        message=("phase=True span name must be a string "
                                 "literal (phase accounting is keyed by "
                                 "exact name)"),
                        symbol=mod.enclosing_function(node) or ""))
                elif phases is not None and name.value not in phases:
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=node.lineno, col=node.col_offset,
                        message=(f"phase span {name.value!r} is not in "
                                 f"the canonical repro_torch.obs.trace.PHASES "
                                 f"tuple — add it there (one source of "
                                 f"truth) or drop phase=True"),
                        symbol=mod.enclosing_function(node) or ""))
        return out
