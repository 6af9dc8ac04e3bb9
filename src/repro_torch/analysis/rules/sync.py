"""R-SYNC — host<->device sync discipline, for torch's device calls.

CUDA launches are asynchronous: device time is only attributable to a
phase if the ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``float()`` /
``torch.cuda.synchronize()`` that *forces* the result executes inside
the trace span that launched the work (see the instrumentation rules in
``repro_torch.obs``).  A sync that escapes every span silently moves
device seconds into whatever phase happens to force the value later.

This is the JAX package's light device-taint analysis with torch's
vocabulary in place of JAX's.  It is not a linter over every
``np.asarray`` (most of those are host-side packing and perfectly
fine):

  * **device sources** — functions whose bodies call ``torch.*``,
    transitively through the in-repo call graph (the kernel wrappers are
    reached that way: they allocate and launch through torch);
    module-level ``x = torch.*(...)`` names and ``self.x = torch.*(...)``
    class attrs count too, and so do ``.to(<device>)`` / ``.cuda()``
    copies and any method called on a device value.  ``HOST_ONLY`` keeps
    out the torch calls that never touch a device queue: device and
    stream bookkeeping (``torch.device``, ``torch.cuda.device_count``,
    ``is_available``, ``current_device``, ``get_device_name``, the
    constructors of ``torch.cuda.Event`` / ``Stream`` and
    ``torch.Generator``, ...), grad and dtype switches
    (``torch.no_grad``, ``torch.inference_mode``,
    ``torch.get_default_dtype``) and ``torch.from_numpy`` (a CPU view of
    a host array).  Tensor metadata (``.shape``, ``.dtype``,
    ``.device``, ``.size()``, ``.numel()``, ...) is host data too;
  * **forcing points** — ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``float`` / ``int`` / ``bool`` and ``np.asarray`` /
    ``np.array`` of a device value, and ``.to("cpu")`` /
    ``.to(device="cpu")`` with a literal; ``torch.cuda.synchronize()``
    and ``<event or stream>.synchronize()`` force whatever is queued, so
    they count wherever they stand (after one, the walk holds no value
    as pending any more).  A copy with ``non_blocking=True`` is not a
    forcing point (its result stays a device value): its force is the
    later synchronize;
  * **barriers** — a device-calling function whose every ``return``
    expression is host-shaped returns *host* data, so its callers are
    clean.  Host-shaped are ``.cpu().numpy()``, ``.cpu()``,
    ``.tolist()``, ``.item()``, ``float`` / ``int`` / ``bool``,
    ``np.asarray`` / ``np.array``, and names bound from the numpy
    constructors (``np.empty`` / ``zeros`` / ``full`` ...) that the
    function fills in place (``scores[idx] = ...``): a force inside the
    function (in a span, or under a caller bracket) already waited for
    the device, and what it hands back lives on the host;
  * **sync points** — forcing calls applied to tainted values inside
    ``core/``, ``search/``, ``serve/``.  A sync is OK when it sits
    lexically inside a ``with *.span(...)`` block, or when every in-repo
    callsite of its enclosing function does (caller-bracket: the span
    that launched the work brackets the helper that forces it).  A call
    that hands a device value to a parameter that its in-repo callee
    forces outside any span of its own (``_merge_shards(pend)`` copies
    ``pend`` back) is a sync point at the callsite; methods called on a
    local bound from an in-repo class (``ev = _Evaluator(...)``;
    ``ev.collect(plan, pending)``) resolve to that class's methods.

The streaming pipeline adds one *legitimate* deferred-sync shape: a
function marked ``@repro_torch.obs.deferred_sync`` enqueues device work
and returns the un-forced tensors on purpose (the force happens later,
in a "device-wait" span).  The decorator is a contract, not an
exemption — this rule enforces both sides of it:

  * a deferred producer is pinned device-returning (it can never be
    classified a barrier, whatever its return shape looks like), so the
    ordinary sync-site check still covers whoever eventually forces its
    results;
  * every in-scope callsite of a deferred producer must itself sit in a
    trace span (lexically, or via the caller-bracket rule) — the span
    that *launches* deferred work owns its dispatch time;
  * decorating a function that never produces device values is flagged:
    a rotted marker would quietly disable barrier analysis on an
    ordinary host helper.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import Finding, Module, RepoIndex
from . import register_rule

SCOPE = ("core/", "search/", "serve/")

DEVICE_PREFIX = "torch."
#: torch calls that never enqueue device work nor return device values
HOST_ONLY = {
    "torch.device", "torch.Generator", "torch.from_numpy",
    "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.set_grad_enabled", "torch.is_grad_enabled", "torch.is_tensor",
    "torch.is_floating_point", "torch.finfo", "torch.iinfo",
    "torch.manual_seed", "torch.get_num_threads", "torch.set_num_threads",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.set_device",
    "torch.cuda.get_device_name", "torch.cuda.get_device_capability",
    "torch.cuda.get_device_properties", "torch.cuda.device",
    "torch.cuda.Event", "torch.cuda.Stream", "torch.cuda.stream",
    "torch.cuda.current_stream", "torch.cuda.default_stream",
    "torch.cuda.memory_allocated", "torch.cuda.max_memory_allocated",
    "torch.cuda.reset_peak_memory_stats", "torch.cuda.empty_cache",
}
#: force everything queued on the device, whatever their arguments
SYNC_ALL = {"torch.cuda.synchronize"}
SYNC_CALLS = {"numpy.asarray", "numpy.array"}
SYNC_BUILTINS = {"float", "int", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
#: numpy constructors: a name bound from one is a host buffer
NUMPY_CTORS = {f"numpy.{n}" for n in (
    "empty", "zeros", "ones", "full", "empty_like", "zeros_like",
    "ones_like", "full_like")}
#: host-side tensor metadata (reading it never waits for the device)
HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
              "requires_grad"}
HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                "stride", "data_ptr", "is_contiguous", "get_device"}
#: builtins whose result is host data whatever they are given
HOST_BUILTINS = {"len", "isinstance", "hasattr"}
DEFERRED_MARKS = {"repro_torch.obs.deferred_sync",
                  "repro_torch.obs.trace.deferred_sync"}


def _is_device_target(dotted: Optional[str]) -> bool:
    if dotted is None:
        return False
    return dotted.startswith(DEVICE_PREFIX) and dotted not in HOST_ONLY \
        and dotted not in SYNC_ALL


def _is_literal(expr: Optional[ast.AST], value) -> bool:
    return isinstance(expr, ast.Constant) and expr.value == value


def _device_copy(index: RepoIndex, mod: Module, call: ast.Call) -> bool:
    """``x.cuda()`` / ``x.to(<device>)``: a copy onto a device.  A
    ``.to(torch.<dtype>)`` conversion is not one, nor a copy to "cpu"."""
    if not isinstance(call.func, ast.Attribute) or \
            call.func.attr not in ("to", "cuda"):
        return False
    if call.func.attr == "cuda":
        return True
    if _cpu_copy(call) is not None:
        return False
    if any(k.arg == "device" for k in call.keywords):
        return True
    if not call.args:
        return False
    first = call.args[0]
    dtype = isinstance(first, (ast.Attribute, ast.Name)) and \
        (index.resolve_name(mod, first) or "").startswith(DEVICE_PREFIX)
    return not dtype


def _cpu_copy(call: ast.Call) -> Optional[bool]:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: True when it blocks,
    False with ``non_blocking=True``; None for any other call."""
    if not (isinstance(call.func, ast.Attribute) and
            call.func.attr == "to"):
        return None
    kw = {k.arg: k.value for k in call.keywords}
    dev = call.args[0] if call.args else kw.get("device")
    if not _is_literal(dev, "cpu"):
        return None
    return not _is_literal(kw.get("non_blocking"), True)


def _param_names(fn: ast.AST) -> List[str]:
    """Positional then keyword-only parameter names ([] for a non-def)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _dotted_chain(expr: ast.AST) -> Optional[str]:
    """'self.cache' / 'x' style chains for taint bookkeeping."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# classification: which functions return device values?
# ---------------------------------------------------------------------------
class _Classifier:
    def __init__(self, index: RepoIndex):
        self.index = index
        # dotted fn -> (module, node)
        self.fns: Dict[str, Tuple[Module, ast.AST]] = {}
        for mod in index.modules.values():
            for qual, node in mod.functions.items():
                self.fns[f"{mod.dotted}.{qual}"] = (mod, node)
        self.classes: Set[str] = {f"{mod.dotted}.{c}"
                                  for mod in index.modules.values()
                                  for c in mod.classes}
        self.device_names: Set[str] = set()     # device module/class attrs
        self._find_device_names()
        self.direct = {d: self._direct_device(*self.fns[d])
                       for d in self.fns}
        self.callees = {d: self._repo_callees(*self.fns[d])
                        for d in self.fns}
        # deferred-sync producers (@repro_torch.obs.deferred_sync): pinned
        # device-returning — they hand back un-forced values by design,
        # so the barrier check must never launder them to host
        self.deferred: Set[str] = {
            d for d, (mod, fn) in self.fns.items()
            if self._is_deferred(mod, fn)}
        self.ret_dev: Dict[str, bool] = {d: d in self.deferred
                                         for d in self.fns}
        self._fixpoint()
        # parameters each function forces to host (`_merge_shards(pend)`
        # copies `pend` back): a call that hands such a parameter a device
        # value is a sync point at the callsite.  Filled on demand.
        self._forces: Dict[str, Set[str]] = {}

    def _is_deferred(self, mod: Module, fn: ast.AST) -> bool:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        for dec in fn.decorator_list:
            target = self.index.resolve_call(mod, dec) if \
                isinstance(dec, ast.Call) else \
                self.index.resolve_name(mod, dec)
            if target in DEFERRED_MARKS:
                return True
        return False

    def _find_device_names(self) -> None:
        for mod in self.index.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                if not self._contains_device_call(mod, node.value):
                    continue
                for t in node.targets:
                    chain = _dotted_chain(t)
                    if chain is None:
                        continue
                    if chain.startswith("self."):
                        qual = mod.enclosing_function(node)
                        if qual and "." in qual:
                            cls = qual.split(".")[0]
                            self.device_names.add(
                                f"{mod.dotted}.{cls}.{chain[5:]}")
                    elif mod.parents.get(node) is mod.tree:
                        self.device_names.add(f"{mod.dotted}.{chain}")

    def _contains_device_call(self, mod: Module, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call) and \
                    _is_device_target(self.index.resolve_call(mod, n)):
                return True
        return False

    def _direct_device(self, mod: Module, fn: ast.AST) -> bool:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in fn.decorator_list:
                target = self.index.resolve_name(mod, dec) if not \
                    isinstance(dec, ast.Call) else \
                    self.index.resolve_call(mod, dec)
                if _is_device_target(target):
                    return True
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                target = self.index.resolve_call(mod, n)
                if _is_device_target(target) or \
                        target in self.device_names or \
                        _device_copy(self.index, mod, n):
                    return True
        return False

    def _is_barrier(self, mod: Module, fn: ast.AST) -> bool:
        """Every return expression is host-shaped: np.asarray/float/int
        calls, ``.cpu()`` / ``.numpy()`` / ``.tolist()`` / ``.item()``,
        numpy constructors, in-repo calls currently known
        host-returning, names assigned from such (a buffer from
        ``np.empty`` stays host however it is filled), tuples/constants
        thereof, and comprehensions of them (``tuple(t.cpu().numpy()
        for t in out)``).  Re-evaluated each fixpoint round (in-repo
        host-ness can flip as ret_dev grows)."""
        host_names: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and \
                    self._host_shaped(mod, n.value, host_names):
                for t in n.targets:
                    targets = t.elts if isinstance(t, (ast.Tuple,
                                                       ast.List)) else [t]
                    for e in targets:
                        if isinstance(e, ast.Name):
                            host_names.add(e.id)
        returns = [n for n in ast.walk(fn)
                   if isinstance(n, ast.Return) and n.value is not None]
        return bool(returns) and all(
            self._host_shaped(mod, r.value, host_names) for r in returns)

    def _host_shaped(self, mod: Module, expr: ast.AST,
                     host_names: Set[str]) -> bool:
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in host_names
        if isinstance(expr, (ast.Tuple, ast.List)):
            return all(self._host_shaped(mod, e, host_names)
                       for e in expr.elts)
        if isinstance(expr, ast.Subscript):
            return self._host_shaped(mod, expr.value, host_names)
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return self._host_shaped(mod, expr.elt, host_names)
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) and \
                    expr.func.id in SYNC_BUILTINS:
                return True
            if isinstance(expr.func, ast.Name) and \
                    expr.func.id in ("tuple", "list") and \
                    len(expr.args) == 1:
                return self._host_shaped(mod, expr.args[0], host_names)
            target = self.index.resolve_call(mod, expr)
            if target in SYNC_CALLS or target in NUMPY_CTORS:
                return True
            if _is_device_target(target) or target in self.device_names:
                return False
            if target in self.fns:
                return not self.ret_dev[target]
            if isinstance(expr.func, ast.Attribute) and (
                    expr.func.attr in SYNC_METHODS or _cpu_copy(expr)):
                return True
        return False

    def _repo_callees(self, mod: Module, fn: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                target = self.index.resolve_call(mod, n)
                if target and target in self.fns:
                    out.add(target)
        return out

    def _fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            for d in self.fns:
                if self.ret_dev[d]:
                    continue
                now = self.direct[d] or \
                    any(self.ret_dev[c] for c in self.callees[d])
                if now and not self._is_barrier(*self.fns[d]):
                    self.ret_dev[d] = True
                    changed = True

    def forced_params(self, d: str) -> Set[str]:
        """Parameters of in-repo function ``d`` that it forces to host
        outside any span of its own: a parameter is forced when seeding
        it as a device value adds an unbracketed sync point to the
        function's walk.  (A force inside the callee's own span is
        attributed there, so the callsite is clean.)  Transitive through
        callees (a parameter handed on to a forcing parameter is
        forced); computed on first use, with a recursive call taken as
        forcing nothing."""
        if d in self._forces:
            return self._forces[d]
        self._forces[d] = set()                 # recursion guard
        mod, fn = self.fns[d]
        qual = d[len(mod.dotted) + 1:]
        params = [a for a in _param_names(fn) if a not in ("self", "cls")]
        out: Set[str] = set()
        if params:
            plain = {id(n) for n, _ in
                     _TaintWalker(self, mod, qual, fn).run()}
            for a in params:
                seeded = _TaintWalker(self, mod, qual, fn, seed={a}).run()
                if any(id(n) not in plain and not mod.in_span_with(n)
                       for n, _ in seeded):
                    out.add(a)
        self._forces[d] = out
        return out

    def call_returns_device(self, mod: Module, call: ast.Call,
                            target: Optional[str] = None) -> bool:
        target = target or self.index.resolve_call(mod, call)
        if target is None:
            return False
        if _is_device_target(target):
            return True
        if target in self.device_names:
            return True
        return bool(self.ret_dev.get(target))


# ---------------------------------------------------------------------------
# per-function taint walk
# ---------------------------------------------------------------------------
class _TaintWalker:
    def __init__(self, cls: _Classifier, mod: Module, qual: str,
                 fn: ast.AST, seed: Optional[Set[str]] = None):
        self.cls = cls
        self.index = cls.index
        self.mod = mod
        self.qual = qual
        self.fn = fn
        self.seed = set(seed or ())
        self.tainted: Set[str] = set(self.seed)
        self.types: Dict[str, str] = {}     # local -> in-repo class
        self.syncs: List[Tuple[ast.AST, str]] = []   # (node, op label)

    def run(self) -> List[Tuple[ast.AST, str]]:
        stmts = sorted(
            (n for n in ast.walk(self.fn)
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.Expr, ast.Return, ast.For, ast.withitem))
             ), key=lambda n: (getattr(n, "lineno", 0),
                               getattr(n, "col_offset", 0)))
        for _ in range(2):              # second pass settles loop carries
            self.syncs = []
            self.tainted |= self.seed
            for st in stmts:
                self._stmt(st)
        return self.syncs

    def _stmt(self, st: ast.AST) -> None:
        if isinstance(st, ast.Assign):
            if isinstance(st.value, ast.Call) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                cls = self.index.resolve_call(self.mod, st.value)
                if cls in self.cls.classes:
                    self.types[st.targets[0].id] = cls
            t = self._taint(st.value)
            for target in st.targets:
                self._bind(target, t)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                t = self._taint(st.value)
                if isinstance(st, ast.AnnAssign):
                    self._bind(st.target, t)
                elif t:
                    self._bind(st.target, True)
        elif isinstance(st, ast.For):
            if self._taint(st.iter):
                self._bind(st.target, True)
        elif isinstance(st, ast.withitem):
            self._taint(st.context_expr)
        elif isinstance(st, (ast.Expr, ast.Return)):
            if st.value is not None:
                self._taint(st.value)

    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
            return
        chain = _dotted_chain(target)
        if chain is None:
            return
        if tainted:
            self.tainted.add(chain)
        else:
            self.tainted.discard(chain)

    def _taint(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in HOST_ATTRS:
                self._taint(e.value)
                return False
            chain = _dotted_chain(e)
            if chain is not None:
                if chain in self.tainted:
                    return True
                head = chain.split(".")[0]
                return head != "self" and head in self.tainted
            return self._taint(e.value)
        if isinstance(e, ast.Call):
            return self._call(e)
        if isinstance(e, ast.Subscript):
            self._taint(e.slice)
            return self._taint(e.value)
        if isinstance(e, (ast.BinOp,)):
            l, r = self._taint(e.left), self._taint(e.right)
            return l or r
        if isinstance(e, ast.UnaryOp):
            return self._taint(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self._taint(v) for v in e.values)
        if isinstance(e, ast.Compare):
            vals = [self._taint(e.left)] + \
                [self._taint(c) for c in e.comparators]
            return any(vals)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._taint(el) for el in e.elts)
        if isinstance(e, ast.Dict):
            return any(self._taint(v) for v in e.values if v is not None)
        if isinstance(e, ast.IfExp):
            self._taint(e.test)
            a, b = self._taint(e.body), self._taint(e.orelse)
            return a or b
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for gen in e.generators:
                self._bind(gen.target, self._taint(gen.iter))
                for cond in gen.ifs:
                    self._taint(cond)
            if isinstance(e, ast.DictComp):
                k, v = self._taint(e.key), self._taint(e.value)
                return k or v
            return self._taint(e.elt)
        if isinstance(e, ast.Starred):
            return self._taint(e.value)
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self._taint(v.value)
            return False
        return False

    def _method(self, e: ast.Call, target: Optional[str]) -> bool:
        """``recv.meth(...)`` on a local value (not a module function,
        nor an in-repo method the index resolves)."""
        if not isinstance(e.func, ast.Attribute):
            return False
        if target is None:
            return True
        head = _dotted_chain(e.func)
        return head is not None and head.startswith("self.") and \
            target not in self.cls.fns

    def _passes_forced(self, e: ast.Call, target: str, pos: List[bool],
                       kws: List[Tuple[Optional[str], bool]]) -> bool:
        """Does the call hand a device value to a parameter that
        ``target`` forces?"""
        fn = self.cls.fns[target][1]
        forced = self.cls.forced_params(target)
        if not forced:
            return False
        names = [x.arg for x in fn.args.posonlyargs + fn.args.args]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        for i, (a, t) in enumerate(zip(e.args, pos)):
            if t and (isinstance(a, ast.Starred) or i >= len(names)
                      or names[i] in forced):
                return True
        return any(t and (k is None or k in forced) for k, t in kws)

    def _resolve(self, e: ast.Call) -> Optional[str]:
        """The index's resolution, plus methods of locals bound from an
        in-repo class (``ev = _Evaluator(...); ev.launch(plan)``)."""
        target = self.index.resolve_call(self.mod, e)
        if target is None and isinstance(e.func, ast.Attribute) and \
                isinstance(e.func.value, ast.Name) and \
                e.func.value.id in self.types:
            cand = f"{self.types[e.func.value.id]}.{e.func.attr}"
            if cand in self.cls.fns:
                return cand
        return target

    def _call(self, e: ast.Call) -> bool:
        target = self._resolve(e)
        method = self._method(e, target)
        # -- forcing (sync) forms ----------------------------------------
        if target in SYNC_ALL or (method and
                                  e.func.attr == "synchronize"):
            for a in list(e.args) + [kw.value for kw in e.keywords]:
                self._taint(a)
            label = target if target in SYNC_ALL else ".synchronize()"
            self.syncs.append((e, label))
            self.tainted.clear()        # what was queued is done now
            return False
        if target in SYNC_CALLS:
            if any(self._taint(a) for a in e.args):
                self.syncs.append((e, target.split(".")[-1]))
            for kw in e.keywords:
                self._taint(kw.value)
            return False                        # result is host
        if target is None and isinstance(e.func, ast.Name) and \
                e.func.id in SYNC_BUILTINS:
            if any(self._taint(a) for a in e.args):
                self.syncs.append((e, e.func.id))
            return False
        if target is None and isinstance(e.func, ast.Name) and \
                e.func.id in HOST_BUILTINS:
            for a in e.args:
                self._taint(a)
            return False
        if method and e.func.attr in SYNC_METHODS:
            if self._taint(e.func.value):
                self.syncs.append((e, f".{e.func.attr}()"))
            return False
        if method and e.func.attr in HOST_METHODS:
            self._taint(e.func.value)
            return False
        if method and _cpu_copy(e) is not None:
            recv = self._taint(e.func.value)
            if _cpu_copy(e):
                if recv:
                    self.syncs.append((e, '.to("cpu")'))
                return False
            return recv                 # non_blocking: forced later
        # -- producing forms ---------------------------------------------
        pos = [self._taint(a) for a in e.args]
        kws = [(kw.arg, self._taint(kw.value)) for kw in e.keywords]
        arg_taint = any(pos) or any(t for _, t in kws)
        if target in self.cls.fns and arg_taint and \
                self._passes_forced(e, target, pos, kws):
            self.syncs.append((e, f"{target.rsplit('.', 1)[-1]}()"))
        if self.cls.call_returns_device(self.mod, e, target):
            return True
        if target and target in self.cls.fns:
            return False                # in-repo, known host-returning
        if method:
            recv = self._taint(e.func.value)
            if _device_copy(self.index, self.mod, e):
                return True             # a copy onto the device
            return recv or arg_taint    # a method of a device value
        return arg_taint                # unknown callee: propagate


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
@register_rule
class SyncRule:
    id = "R-SYNC"
    name = "device-sync-in-span"
    description = ("forcing a torch value to host (.item()/.cpu()/"
                   ".numpy()/float()/np.asarray/torch.cuda.synchronize) "
                   "in core/, search/, serve/ must happen inside a trace "
                   "span (lexically, or via every callsite) so device "
                   "time lands in the right phase")

    def run(self, index: RepoIndex) -> List[Finding]:
        cls = _Classifier(index)
        out: List[Finding] = []
        for mod in index.modules.values():
            if not mod.relpath.startswith(SCOPE):
                continue
            for qual, fn in mod.functions.items():
                for node, op in _TaintWalker(cls, mod, qual, fn).run():
                    if mod.in_span_with(node):
                        continue
                    if self._caller_bracketed(index, mod, qual):
                        continue
                    out.append(Finding(
                        rule=self.id, path=index.repo_rel(mod),
                        line=node.lineno, col=node.col_offset,
                        message=(f"`{op}` forces a device value to host "
                                 f"outside any trace span — device time "
                                 f"escapes phase attribution; wrap it in "
                                 f"`with current_tracer().span(...)` or "
                                 f"bracket every callsite of {qual} in "
                                 f"a span"),
                        symbol=qual))
        out.extend(self._deferred_contract(index, cls))
        return out

    def _deferred_contract(self, index: RepoIndex,
                           cls: _Classifier) -> List[Finding]:
        """Both sides of the @deferred_sync contract: the marker only on
        genuine device producers, and every in-scope launch site inside
        a span (the launching span owns dispatch/compile time)."""
        out: List[Finding] = []
        for d in sorted(cls.deferred):
            mod, fn = cls.fns[d]
            name = d[len(mod.dotted) + 1:]
            produces = cls.direct[d] or any(
                cls.ret_dev[c] for c in cls.callees[d] - {d})
            if not produces:
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(mod),
                    line=fn.lineno, col=fn.col_offset,
                    message=(f"@deferred_sync on {name} but nothing in "
                             f"it (or its callees) produces device "
                             f"values — a stale marker disables barrier "
                             f"analysis on a host helper; drop it"),
                    symbol=name))
            for site in index.callsites(d):
                if not site.module.relpath.startswith(SCOPE):
                    continue
                if site.in_span:
                    continue
                if site.caller is not None and self._caller_bracketed(
                        index, site.module, site.caller):
                    continue
                out.append(Finding(
                    rule=self.id, path=index.repo_rel(site.module),
                    line=site.node.lineno, col=site.node.col_offset,
                    message=(f"call to deferred-sync producer {name} "
                             f"outside any trace span — the launching "
                             f"span must own the dispatch/compile time "
                             f"it defers; wrap the call in `with "
                             f"current_tracer().span(...)`"),
                    symbol=site.caller or ""))
        return out

    @staticmethod
    def _caller_bracketed(index: RepoIndex, mod: Module,
                          qual: str) -> bool:
        sites = index.callsites(f"{mod.dotted}.{qual}")
        return bool(sites) and all(s.in_span for s in sites)
