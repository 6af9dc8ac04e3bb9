"""trimlint engine for the PyTorch port: parse the repo once, index it,
run the rules.

The index is deliberately lightweight — per-module ASTs with parent
links, a function table keyed by ``(relpath, qualname)``, an import/alias
resolver that turns ``F.softmax`` into ``torch.nn.functional.softmax`` and
``_eval_group(...)`` into ``repro_torch.search.batch_frontier._eval_group``,
and a reverse callsite index with "is this call lexically inside a
``with *.span(...)``" flags.  Rules are pure functions over the index;
nothing here imports (or needs) torch/numpy, so the whole pass runs on
a bare Python install.  It is the JAX package's analyzer walking
``src/repro_torch`` instead of ``src/repro``.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

PKG = "repro_torch"               # dotted root of the analyzed package
SRC_REL = Path("src") / PKG       # package dir relative to the repo root


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Finding:
    """One rule violation, anchored to a file location.

    ``fingerprint()`` hashes rule + path + symbol + message and excludes
    the line number, so baseline entries survive unrelated edits that
    shift code up or down."""
    rule: str
    path: str                     # repo-relative posix path
    line: int
    col: int
    message: str
    symbol: str = ""              # enclosing function/class qualname

    def fingerprint(self) -> str:
        blob = "|".join((self.rule, self.path, self.symbol, self.message))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "symbol": self.symbol, "fingerprint": self.fingerprint()}

    def render(self) -> str:
        sym = f"  [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}{sym}")


# ---------------------------------------------------------------------------
# per-module record
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Module:
    relpath: str                  # under src/repro_torch ("search/cache.py")
    path: Path
    tree: ast.Module
    source: str
    dotted: str                   # "repro_torch.search.cache"
    parents: Dict[ast.AST, ast.AST] = dataclasses.field(default_factory=dict)
    # local name -> fully dotted origin ("F" -> "torch.nn.functional",
    # "evaluate_batch" -> "repro_torch.core.batch_eval.evaluate_batch")
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # top-level defs: qualname -> node ("cache_key", "ResultCache.get")
    functions: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = dataclasses.field(default_factory=dict)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[str]:
        """Qualname of the innermost enclosing def, or None."""
        chain = [node] + list(self.ancestors(node))
        names: List[str] = []
        for n in chain:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.append(n.name)
        return ".".join(reversed(names)) or None

    def in_span_with(self, node: ast.AST) -> bool:
        """True iff ``node`` sits lexically inside a ``with *.span(...)``
        (any receiver — Tracer instances, ``current_tracer()``, ...)."""
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    if _is_span_call(item.context_expr):
                        return True
        return False


def _is_span_call(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "span")


def _attach_parents(mod: Module) -> None:
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            mod.parents[child] = parent


def _collect_aliases(mod: Module) -> None:
    """Resolve imports into fully dotted origins.  Relative imports are
    anchored at the module's own package path."""
    pkg_parts = mod.dotted.split(".")[:-1]      # package containing module
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
                if a.asname:
                    mod.aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:                      # relative
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                origin = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                origin = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                mod.aliases[a.asname or a.name] = f"{origin}.{a.name}"


def _collect_defs(mod: Module) -> None:
    def visit(body: Iterable[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                mod.functions[qual] = node
            elif isinstance(node, ast.ClassDef):
                mod.classes[f"{prefix}{node.name}"] = node
                visit(node.body, f"{prefix}{node.name}.")
    visit(mod.tree.body, "")


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CallSite:
    module: Module
    node: ast.Call
    caller: Optional[str]         # enclosing function qualname
    in_span: bool


class RepoIndex:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.modules: Dict[str, Module] = {}   # src/repro_torch, by relpath
        self.tests: Dict[str, Module] = {}         # tests/, by filename
        # dotted function name -> callsites across src modules
        self._callsites: Optional[Dict[str, List[CallSite]]] = None

    # -- loading ---------------------------------------------------------
    def load(self) -> "RepoIndex":
        pkg_dir = self.root / SRC_REL
        for path in sorted(pkg_dir.rglob("*.py")):
            rel = path.relative_to(pkg_dir).as_posix()
            if rel.startswith("analysis/"):
                continue                    # the linter doesn't lint itself
            self.modules[rel] = self._parse(path, rel)
        tests_dir = self.root / "tests"
        if tests_dir.is_dir():
            for path in sorted(tests_dir.glob("*.py")):
                rel = f"tests/{path.name}"
                self.tests[rel] = self._parse(path, rel, dotted=path.stem)
        return self

    def _parse(self, path: Path, rel: str,
               dotted: Optional[str] = None) -> Module:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        if dotted is None:
            dotted = PKG + "." + rel[:-3].replace("/", ".")
            if dotted.endswith(".__init__"):
                dotted = dotted[:-len(".__init__")]
        mod = Module(relpath=rel, path=path, tree=tree, source=source,
                     dotted=dotted)
        _attach_parents(mod)
        _collect_aliases(mod)
        _collect_defs(mod)
        return mod

    def get(self, relpath: str) -> Optional[Module]:
        return self.modules.get(relpath)

    def repo_rel(self, mod: Module) -> str:
        """Repo-relative path for findings
        ("src/repro_torch/search/cache.py")."""
        if mod.relpath.startswith("tests/"):
            return mod.relpath
        return (SRC_REL / mod.relpath).as_posix()

    # -- name resolution -------------------------------------------------
    def resolve_call(self, mod: Module, call: ast.Call) -> Optional[str]:
        """Dotted target of a call, with the leading alias expanded:
        ``F.softmax(...)`` -> "torch.nn.functional.softmax"; a bare
        in-module function call -> "repro_torch.<mod>.<fn>";
        ``self.meth(...)`` -> the enclosing class's
        "repro_torch.<mod>.<Class>.<meth>" when defined there."""
        return self.resolve_name(mod, call.func, call)

    def resolve_name(self, mod: Module, expr: ast.AST,
                     context: Optional[ast.AST] = None) -> Optional[str]:
        parts: List[str] = []
        cur = expr
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(cur.id)
        parts.reverse()
        head, rest = parts[0], parts[1:]
        if head == "self" and context is not None:
            qual = mod.enclosing_function(context)
            if qual and "." in qual and rest:
                cls = qual.split(".")[0]
                if f"{cls}.{rest[0]}" in mod.functions or cls in mod.classes:
                    return ".".join([mod.dotted, cls] + rest)
            return None
        origin = mod.aliases.get(head)
        if origin is None:
            if head in mod.functions or head in mod.classes:
                origin = f"{mod.dotted}.{head}"
            else:
                return None                 # builtin / local variable
        return ".".join([origin] + rest) if rest else origin

    # -- callsites -------------------------------------------------------
    def callsites(self, dotted: str) -> List[CallSite]:
        if self._callsites is None:
            self._callsites = {}
            for mod in self.modules.values():
                for node in ast.walk(mod.tree):
                    if not isinstance(node, ast.Call):
                        continue
                    target = self.resolve_call(mod, node)
                    if target is None:
                        continue
                    self._callsites.setdefault(target, []).append(CallSite(
                        module=mod, node=node,
                        caller=mod.enclosing_function(node),
                        in_span=mod.in_span_with(node)))
        return self._callsites.get(dotted, [])

    def function(self, dotted: str) -> Optional[Tuple[Module, ast.AST]]:
        """Look up an in-repo function/method by dotted name."""
        for mod in self.modules.values():
            if dotted.startswith(mod.dotted + "."):
                qual = dotted[len(mod.dotted) + 1:]
                node = mod.functions.get(qual)
                if node is not None:
                    return mod, node
        return None

    # -- dataclass fields ------------------------------------------------
    def dataclass_fields(self, relpath: str, cls: str) -> List[str]:
        """Annotated field names of a (data)class, in declaration order;
        [] when the module or class is absent."""
        mod = self.modules.get(relpath)
        if mod is None or cls not in mod.classes:
            return []
        out = []
        for node in mod.classes[cls].body:
            if isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                out.append(node.target.id)
        return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def find_root(start: Optional[Path] = None) -> Path:
    """Locate the repo root: the nearest ancestor containing src/repro_torch.
    Falls back to this file's own checkout."""
    candidates = []
    if start is not None:
        candidates += [Path(start)] + list(Path(start).resolve().parents)
    here = Path(__file__).resolve()
    candidates += [here.parents[3]]   # src/repro_torch/analysis/engine.py
    for cand in candidates:
        if (cand / SRC_REL).is_dir():
            return cand
    raise FileNotFoundError(
        f"cannot locate a repo root containing {SRC_REL} from {start}")


def build_index(root: Optional[Path] = None) -> RepoIndex:
    return RepoIndex(find_root(root) if root is None or
                     not (Path(root) / SRC_REL).is_dir()
                     else Path(root)).load()


def run_analysis(root: Optional[Path] = None,
                 rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Build the index and run the (selected) rules; -> sorted findings."""
    from .rules import get_rules
    index = build_index(root)
    findings: List[Finding] = []
    for rule in get_rules(rules):
        findings.extend(rule.run(index))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
