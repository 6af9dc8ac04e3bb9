"""Tests for `repro_torch.analysis` (trimlint for the PyTorch port).

`tests/test_analysis.py` on the port, in the same three layers, with the
faults shaped as torch code:

  * fixture tests — tiny synthetic `src/repro_torch` trees, one good and
    one bad variant per rule, so each rule's detection logic is pinned
    in isolation (R-SYNC with torch's device sources, forcing points and
    barriers);
  * real-tree tests — HEAD must be clean against the port's empty
    `trimlint-torch-baseline.json`, and seeded mutations of a *copy* of
    the live tree must each produce exactly the expected finding;
  * CLI tests — baseline add/expire round-trip, JSON/SARIF output
    shape, exit codes.

Everything here runs the analyzer only: no torch, no card."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import Finding, build_index, run_analysis
from repro_torch.analysis.__main__ import main as trimlint_main
from repro_torch.analysis.rules import RULES, get_rules

REPO = Path(__file__).resolve().parents[1]
PORT_SRC = "src/repro_torch"
_CONTRACT = "tests/test_torch_strategy_contract.py"


def mk_repo(tmp_path: Path, files) -> Path:
    """Materialize a minimal fixture repo ({relpath: source})."""
    root = tmp_path / "fixture"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _copy_repo(tmp_path: Path) -> Path:
    """Copy of the live port (src/repro_torch, and of tests/ the one file
    a rule reads: the strategy contract test) for mutation testing."""
    root = tmp_path / "repo"
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(REPO / PORT_SRC, root / PORT_SRC, ignore=ignore)
    (root / "tests").mkdir()
    shutil.copy(REPO / _CONTRACT, root / _CONTRACT)
    return root


@pytest.fixture(scope="module")
def live():
    """The live repo's index, built once for the read-only checks."""
    return build_index(REPO)


def _mutate(root: Path, rel: str, old: str, new: str) -> None:
    p = root / rel
    text = p.read_text()
    assert old in text, f"mutation anchor not found in {rel}: {old!r}"
    p.write_text(text.replace(old, new, 1))


def _sync(tmp_path, src, rel="core/score.py"):
    root = mk_repo(tmp_path, {f"{PORT_SRC}/{rel}": src})
    return run_analysis(root, rules=["R-SYNC"])


# ---------------------------------------------------------------------------
# R-SYNC fixtures
# ---------------------------------------------------------------------------
_SYNC_DEVICE = """\
    import numpy as np
    import torch

    def device_scores(x):
        return torch.as_tensor(x, device="cuda") * 2.0
"""

SYNC_BAD = _SYNC_DEVICE + """
    def collect(x):
        s = device_scores(x)
        return s.sum().item()
"""

SYNC_GOOD_SPAN = _SYNC_DEVICE + """
    def collect(x, tr):
        s = device_scores(x)
        with tr.span("score"):
            return s.sum().item()
"""

SYNC_GOOD_CALLER = _SYNC_DEVICE + """
    def _pull(x):
        s = device_scores(x)
        return s.cpu().numpy()

    def collect(x, tr):
        with tr.span("score"):
            return _pull(x)
"""

SYNC_GOOD_HOST = """\
    import numpy as np
    import torch

    def pack(rows):
        a = np.asarray(rows)
        return torch.from_numpy(a).numpy()
"""


def test_sync_unbracketed_item_fires(tmp_path):
    findings = _sync(tmp_path, SYNC_BAD)
    assert [f.rule for f in findings] == ["R-SYNC"]
    assert findings[0].symbol == "collect"
    assert ".item()" in findings[0].message


def test_sync_lexical_span_is_clean(tmp_path):
    assert _sync(tmp_path, SYNC_GOOD_SPAN) == []


def test_sync_caller_bracket_is_clean(tmp_path):
    assert _sync(tmp_path, SYNC_GOOD_CALLER) == []


def test_sync_host_only_asarray_is_clean(tmp_path):
    # np.asarray over host data is packing, and torch.from_numpy is a CPU
    # view of a host array: neither is a device sync
    assert _sync(tmp_path, SYNC_GOOD_HOST, "core/packer.py") == []


@pytest.mark.parametrize("ret", [
    "s.cpu().numpy()", "s.tolist()", "s.item()",
    "tuple(t.cpu().numpy() for t in (s, s))",
    '[t.to("cpu") for t in (s, s)]'])
def test_sync_barrier_callers_are_clean(tmp_path, ret):
    # a device-calling helper whose returns are host-shaped hands back
    # host data: its callers are clean
    src = _SYNC_DEVICE + f"""
    def scores_np(x):
        s = device_scores(x)
        with current_tracer().span("score"):
            return {ret}

    def downstream(x):
        v = scores_np(x)
        return float(v[0])
"""
    assert _sync(tmp_path, src) == []


# -- torch's forcing points -------------------------------------------------
FORCES = [
    (".item()", "s.item()"),
    (".tolist()", "s.tolist()"),
    (".cpu()", "s.cpu()"),
    (".numpy()", "s.numpy()"),
    ("float", "float(s)"),
    ("int", "int(s)"),
    ("bool", "bool(s)"),
    ("asarray", "np.asarray(s)"),
    ("array", "np.array(s)"),
    ('.to("cpu")', 's.to("cpu")'),
    ('.to("cpu")', 's.to(device="cpu")'),
    ("torch.cuda.synchronize", "torch.cuda.synchronize()"),
    (".synchronize()", "ev.synchronize()"),
]


def _force_src(expr, in_span):
    body = (f"        with tr.span(\"score\"):\n            return {expr}\n"
            if in_span else f"        return {expr}\n")
    return _SYNC_DEVICE + (
        "\n    def collect(x, tr):\n"
        "        s = device_scores(x)\n"
        "        ev = torch.cuda.Event()\n"
        "        ev.record()\n" + body)


@pytest.mark.parametrize("label,expr", FORCES,
                         ids=[e for _, e in FORCES])
def test_sync_torch_forcing_point_fires_outside_a_span(tmp_path, label,
                                                       expr):
    findings = _sync(tmp_path, _force_src(expr, in_span=False))
    assert len(findings) == 1, findings
    assert findings[0].symbol == "collect"
    assert f"`{label}`" in findings[0].message


@pytest.mark.parametrize("label,expr", FORCES,
                         ids=[e for _, e in FORCES])
def test_sync_torch_forcing_point_in_a_span_is_clean(tmp_path, label,
                                                     expr):
    assert _sync(tmp_path, _force_src(expr, in_span=True)) == []


def test_sync_non_blocking_copy_is_forced_by_the_later_synchronize(
        tmp_path):
    src = _SYNC_DEVICE + """
    def collect(x, tr):
        s = device_scores(x)
        h = s.to("cpu", non_blocking=True)
        torch.cuda.synchronize()
        return h.numpy()
"""
    findings = _sync(tmp_path, src)
    assert len(findings) == 1
    assert "torch.cuda.synchronize" in findings[0].message
    bracketed = src.replace(
        "        torch.cuda.synchronize()\n",
        "        with tr.span(\"wait\"):\n"
        "            torch.cuda.synchronize()\n")
    assert _sync(tmp_path / "b", bracketed) == []


@pytest.mark.parametrize("expr", [
    "int(torch.cuda.device_count())",
    "bool(torch.cuda.is_available())",
    "int(torch.cuda.current_device())",
    "str(torch.cuda.get_device_name(0))",
    "str(torch.device('cuda'))",
    "str(torch.get_default_dtype())",
    "torch.cuda.Event(enable_timing=True)",
    "torch.cuda.Stream()",
    "torch.Generator().manual_seed(0)",
])
def test_sync_host_only_torch_calls_are_clean(tmp_path, expr):
    src = f"""\
    import torch

    def n_devices():
        return {expr}

    def plan(rows):
        return max(1, int(n_devices())) * rows
"""
    assert _sync(tmp_path, src, "search/driver.py") == []


@pytest.mark.parametrize("copy,device", [
    ("t.to(dev)", True), ("t.cuda()", True),
    ("t.to(device=dev, dtype=torch.float32)", True),
    ("t.to(torch.float32)", False), ('t.to("cpu")', False)])
def test_sync_device_copy_is_a_device_source(tmp_path, copy, device):
    src = f"""\
    import torch

    def upload(a, dev):
        t = torch.from_numpy(a)
        return {copy}

    def total(a, dev):
        return upload(a, dev).sum().item()
"""
    findings = _sync(tmp_path, src)
    assert [f.symbol for f in findings] == (["total"] if device else [])


def test_sync_tensor_metadata_is_host(tmp_path):
    src = _SYNC_DEVICE + """
    def rows(x):
        s = device_scores(x)
        return int(s.shape[0]) + int(s.numel()) + int(s.size(0)) + \
            int(len(s))
"""
    assert _sync(tmp_path, src) == []


def test_sync_method_of_a_device_value_is_device(tmp_path):
    src = _SYNC_DEVICE + """
    def best(x):
        s = device_scores(x)
        i = s.argmin()
        return int(i)
"""
    findings = _sync(tmp_path, src)
    assert [f.symbol for f in findings] == ["best"]
    assert "`int`" in findings[0].message


def test_sync_numpy_buffer_filled_in_place_is_a_barrier(tmp_path):
    src = _SYNC_DEVICE + """
    def score(x, tr):
        out = np.empty((4,), np.float64)
        with tr.span("score"):
            out[:] = device_scores(x).cpu().numpy()
        return out

    def best(x, tr):
        return int(np.argmin(score(x, tr)))
"""
    assert _sync(tmp_path, src) == []
    # the same caller over a device-returning helper forces outside a span
    leaky = src.replace("        return out\n",
                        "        return device_scores(x)\n")
    findings = _sync(tmp_path / "b", leaky)
    assert [f.symbol for f in findings] == ["best"]


_FORCED_PARAM = _SYNC_DEVICE + """
    def _pull(t):
        return t.cpu().numpy()
"""


def test_sync_forced_parameter_fires_at_the_callsite(tmp_path):
    src = _FORCED_PARAM + """
    def run(x):
        s = device_scores(x)
        return _pull(s)
"""
    findings = _sync(tmp_path, src)
    assert len(findings) == 1
    assert findings[0].symbol == "run"
    assert "`_pull()`" in findings[0].message


def test_sync_forced_parameter_in_a_span_is_clean(tmp_path):
    src = _FORCED_PARAM + """
    def run(x, tr):
        s = device_scores(x)
        with tr.span("score"):
            return _pull(s)
"""
    assert _sync(tmp_path, src) == []
    # a callee that forces inside its own span leaves its callers clean
    own = src.replace(
        "        return t.cpu().numpy()\n",
        "        with current_tracer().span(\"pull\"):\n"
        "            return t.cpu().numpy()\n").replace(
        "        with tr.span(\"score\"):\n            return _pull(s)\n",
        "        return _pull(s)\n")
    assert _sync(tmp_path / "b", own) == []


def test_sync_methods_of_a_local_instance_resolve(tmp_path):
    src = _SYNC_DEVICE + """
    class Scorer:
        def launch(self, x):
            return device_scores(x)

        def collect(self, p):
            return p.cpu().numpy()

    def run(x):
        ev = Scorer()
        p = ev.launch(x)
        return ev.collect(p)
"""
    findings = _sync(tmp_path, src)
    assert [f.symbol for f in findings] == ["run"]
    assert "`collect()`" in findings[0].message


# -- @deferred_sync contract ------------------------------------------------
_SYNC_DEFERRED = """\
    import numpy as np
    import torch
    from repro_torch.obs import deferred_sync

    @deferred_sync
    def launch(x):
        return torch.as_tensor(x, device="cuda") * 2.0
"""


def test_deferred_sync_bare_callsite_fires(tmp_path):
    src = _SYNC_DEFERRED + """
    def run(x):
        return launch(x)
"""
    findings = _sync(tmp_path, src)
    assert len(findings) == 1
    assert "deferred-sync producer" in findings[0].message
    assert findings[0].symbol == "run"


def test_deferred_sync_span_bracketed_is_clean(tmp_path):
    src = _SYNC_DEFERRED + """
    def run(x, tr):
        with tr.span("score"):
            p = launch(x)
        with tr.span("device-wait"):
            return p.cpu().numpy()
"""
    assert _sync(tmp_path, src) == []


def test_deferred_sync_caller_bracket_is_clean(tmp_path):
    src = _SYNC_DEFERRED + """
    def _go(x):
        return launch(x)

    def run(x, tr):
        with tr.span("score"):
            return _go(x)
"""
    assert _sync(tmp_path, src) == []


def test_deferred_sync_unforced_result_still_needs_span(tmp_path):
    src = _SYNC_DEFERRED + """
    def run(x, tr):
        with tr.span("score"):
            p = launch(x)
        return p.cpu().numpy()
"""
    findings = _sync(tmp_path, src)
    assert len(findings) == 1
    assert ".cpu()" in findings[0].message
    assert findings[0].symbol == "run"


def test_deferred_sync_stale_marker_fires(tmp_path):
    # host-only torch calls produce nothing on the device
    src = """\
    import numpy as np
    import torch
    from repro_torch.obs import deferred_sync

    @deferred_sync
    def shuffle(rows):
        return np.asarray(rows)[:torch.cuda.device_count()]

    def run(rows, tr):
        with tr.span("pack"):
            return shuffle(rows)
"""
    findings = _sync(tmp_path, src, "core/packer.py")
    assert len(findings) == 1
    assert "stale marker" in findings[0].message
    assert findings[0].symbol == "shuffle"


def test_live_repo_declares_deferred_producers(live):
    """The streaming pipeline's launch path is marked and bracketed in
    the live tree (the contract the fixtures above enforce)."""
    from repro_torch.analysis.rules.sync import _Classifier
    cls = _Classifier(live)
    assert "repro_torch.search.batch_frontier.fused_launch" in cls.deferred
    assert "repro_torch.search.batch_frontier._dispatch_shards" in \
        cls.deferred
    for d in cls.deferred:
        assert cls.ret_dev[d]           # pinned device-returning
    # the marker on _dispatch_shards is live: it enqueues torch work
    assert cls.callees["repro_torch.search.batch_frontier._dispatch_shards"]
    # ...and fused_collect forces what fused_launch returned
    assert cls.forced_params(
        "repro_torch.search.batch_frontier.fused_collect") == {"pending"}


def test_live_repo_probe_sites_are_host(live):
    """JAX's R-SYNC vocabulary over the port reported five sync points;
    each forces host data under torch's: the oracle's copy back
    (`batch_scores_arrays`) returns `.cpu().numpy()`, `score_mapspace`
    returns `np.asarray` copies or numpy buffers it fills in place (both
    barriers), and the round sizer reads `torch.cuda.device_count()`
    (host-only)."""
    from repro_torch.analysis.rules.sync import _Classifier
    cls = _Classifier(live)
    pre = "repro_torch.core."
    d = pre + "batch_eval.batch_scores_arrays"
    assert any(cls.ret_dev[c] for c in cls.callees[d])  # launches...
    assert not cls.ret_dev[d]                           # ...returns host
    d = pre + "backend.score_mapspace"
    assert cls._is_barrier(*cls.fns[d])
    # the kernel's wrapper copies its outputs back in "kernel.d2h"
    d = "repro_torch.kernels.mapspace_eval.ops._run"
    assert cls.direct[d] or any(cls.ret_dev[c] for c in cls.callees[d])
    assert not cls.ret_dev[d]
    for fn in ("backend.score_mapspace", "backend.best_index",
               "batch_eval.batch_scores", "batch_eval.batch_best_index"):
        assert not cls.ret_dev[pre + fn], fn
    d = "repro_torch.search.driver.auto_round_size"
    assert not cls.direct[d] and not cls.ret_dev[d]


# ---------------------------------------------------------------------------
# R-DET fixtures
# ---------------------------------------------------------------------------
def test_det_unseeded_rng_in_scoring_module(tmp_path):
    bad = """\
    import numpy as np

    def sample(n):
        rng = np.random.default_rng()
        return rng.integers(0, n)
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/core/evaluator.py": bad})
    findings = run_analysis(root, rules=["R-DET"])
    assert [f.rule for f in findings] == ["R-DET"]
    assert "unseeded" in findings[0].message
    assert findings[0].symbol == "sample"

    good = bad.replace("default_rng()", "default_rng(n)")
    root2 = mk_repo(tmp_path / "g",
                    {f"{PORT_SRC}/core/evaluator.py": good})
    assert run_analysis(root2, rules=["R-DET"]) == []


def test_det_kernel_scoring_path_is_a_scoring_module(tmp_path):
    # the "cuda" engine scores through the mapspace kernel's modules
    bad = """\
    import time

    def derive_rows(n):
        return n, time.time()
"""
    root = mk_repo(tmp_path,
                   {f"{PORT_SRC}/kernels/mapspace_eval/ref.py": bad})
    findings = run_analysis(root, rules=["R-DET"])
    assert [f.symbol for f in findings] == ["derive_rows"]
    assert "time.time" in findings[0].message


def test_det_wallclock_and_global_draw_in_strategy(tmp_path):
    bad = """\
    import random
    import time

    def propose(pool):
        t = time.time()
        return random.choice(pool), t
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/search/strategies.py": bad})
    msgs = [f.message for f in run_analysis(root, rules=["R-DET"])]
    assert len(msgs) == 2
    assert any("time.time" in m for m in msgs)
    assert any("random.choice" in m for m in msgs)


def test_det_digest_closure_bans(tmp_path):
    bad = """\
    import hashlib
    import json

    CACHE_FORMAT = 1

    def cache_key(payload):
        for k in set(payload):
            pass
        blob = json.dumps(payload)
        return hashlib.sha256(blob.encode()).hexdigest()
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/search/cache.py": bad})
    msgs = [f.message for f in run_analysis(root, rules=["R-DET"])]
    assert len(msgs) == 2
    assert any("sort_keys" in m for m in msgs)
    assert any("set" in m for m in msgs)

    good = bad.replace("set(payload)", "sorted(payload)").replace(
        "json.dumps(payload)", "json.dumps(payload, sort_keys=True)")
    root2 = mk_repo(tmp_path / "g", {f"{PORT_SRC}/search/cache.py": good})
    assert run_analysis(root2, rules=["R-DET"]) == []


def test_det_seeded_rng_outside_digest_closure_is_clean(tmp_path):
    ok = """\
    import time

    def gc_stale(path):
        return time.time()
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/search/cache.py": ok})
    assert run_analysis(root, rules=["R-DET"]) == []


def test_live_repo_has_every_digest_root(live):
    from repro_torch.analysis.rules.determinism import (DIGEST_ROOTS,
                                                        _closure)
    closure = _closure(live)
    for root in DIGEST_ROOTS:
        assert root in closure, root
    assert len(DIGEST_ROOTS) == 5


# ---------------------------------------------------------------------------
# R-TRACE fixtures
# ---------------------------------------------------------------------------
_TRACE_MOD = """\
    DRIVER_PHASES = ("score", "pack")
    PHASES = DRIVER_PHASES + ("serve.tick",)
"""


def test_trace_bare_span_and_bad_phase(tmp_path):
    bad = """\
    def run(tr):
        sp = tr.span("leak")
        with tr.span("scoring", phase=True):
            pass
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/obs/trace.py": _TRACE_MOD,
                              f"{PORT_SRC}/core/driver.py": bad})
    msgs = [f.message for f in run_analysis(root, rules=["R-TRACE"])]
    assert len(msgs) == 2
    assert any("outside a `with`" in m for m in msgs)
    assert any("not in the canonical" in m for m in msgs)


def test_trace_good_spans_are_clean(tmp_path):
    good = """\
    def run(tr):
        with tr.span("score", phase=True):
            pass
        with tr.span("serve.tick", phase=True):
            pass
        with tr.span("anything-goes-unphased", rows=3):
            pass
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/obs/trace.py": _TRACE_MOD,
                              f"{PORT_SRC}/core/driver.py": good})
    assert run_analysis(root, rules=["R-TRACE"]) == []


def test_trace_phase_name_must_be_literal(tmp_path):
    bad = """\
    def run(tr, name):
        with tr.span(name, phase=True):
            pass
"""
    root = mk_repo(tmp_path, {f"{PORT_SRC}/obs/trace.py": _TRACE_MOD,
                              f"{PORT_SRC}/core/driver.py": bad})
    msgs = [f.message for f in run_analysis(root, rules=["R-TRACE"])]
    assert len(msgs) == 1 and "string literal" in msgs[0]


def test_live_repo_phases_come_from_the_ports_trace(live):
    from repro_torch.analysis.rules.tracing import canonical_phases
    from repro_torch.obs.trace import PHASES
    assert canonical_phases(live) == PHASES


# ---------------------------------------------------------------------------
# R-CACHE fixtures
# ---------------------------------------------------------------------------
_CACHE_FIXTURE = {
    f"{PORT_SRC}/core/workload.py": """\
    import dataclasses

    @dataclasses.dataclass
    class Workload:
        dims: tuple
        sparsity: float
""",
    f"{PORT_SRC}/core/designer.py": """\
    import dataclasses

    @dataclasses.dataclass
    class Level:
        size_words: int

    @dataclasses.dataclass
    class HardwareDesc:
        name: str
        freq: float
""",
    f"{PORT_SRC}/core/mapper.py": """\
    import dataclasses

    @dataclasses.dataclass
    class MapperConfig:
        max_mappings: int
        seed: int
""",
    f"{PORT_SRC}/core/evaluator.py": """\
    def score(wl, hw, cfg):
        return len(wl.dims) * wl.sparsity * hw.freq * cfg.max_mappings
""",
    f"{PORT_SRC}/search/cache.py": """\
    import dataclasses
    import hashlib
    import json

    from ..core.designer import HardwareDesc
    from ..core.mapper import MapperConfig
    from ..core.workload import Workload

    CACHE_FORMAT = 1

    def _workload_sig(wl: Workload):
        return {"dims": list(wl.dims), "sparsity": wl.sparsity}

    def _hw_sig(hw: HardwareDesc):
        return {"freq": hw.freq}

    def _cfg_sig(cfg: MapperConfig):
        return dataclasses.asdict(cfg)

    def cache_key(wl: Workload, hw: HardwareDesc, cfg: MapperConfig,
                  goal, backend="torch", mapspace=None):
        payload = {"v": CACHE_FORMAT, "workload": _workload_sig(wl),
                   "hw": _hw_sig(hw), "cfg": _cfg_sig(cfg), "goal": goal,
                   "backend": backend}
        if mapspace is not None:
            payload["mapspace"] = mapspace
        blob = json.dumps(payload, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()
""",
}
_CACHE = f"{PORT_SRC}/search/cache.py"


def test_cache_complete_key_is_clean(tmp_path):
    root = mk_repo(tmp_path, _CACHE_FIXTURE)
    assert run_analysis(root, rules=["R-CACHE"]) == []


def test_cache_uncovered_field_fires(tmp_path):
    files = dict(_CACHE_FIXTURE)
    files[_CACHE] = files[_CACHE].replace(', "sparsity": wl.sparsity', "")
    root = mk_repo(tmp_path, files)
    findings = run_analysis(root, rules=["R-CACHE"])
    assert [f.rule for f in findings] == ["R-CACHE"]
    assert "Workload.sparsity" in findings[0].message
    assert findings[0].path.endswith("core/evaluator.py")


def test_cache_exempt_field_is_quiet(tmp_path):
    files = dict(_CACHE_FIXTURE)
    files[f"{PORT_SRC}/core/evaluator.py"] = """\
    def score(wl, hw, cfg):
        return (hw.name, wl.sparsity * hw.freq * cfg.max_mappings)
"""
    root = mk_repo(tmp_path, files)
    assert run_analysis(root, rules=["R-CACHE"]) == []


def test_cache_asdict_sweeps_all_fields(tmp_path):
    files = dict(_CACHE_FIXTURE)
    files[f"{PORT_SRC}/core/evaluator.py"] = """\
    def score(wl, hw, cfg):
        return wl.sparsity * hw.freq * cfg.seed
"""
    root = mk_repo(tmp_path, files)
    assert run_analysis(root, rules=["R-CACHE"]) == []


@pytest.mark.parametrize("key,old", [
    ("backend", ',\n               "backend": backend}'),
    ("mapspace", '    if mapspace is not None:\n'
                 '        payload["mapspace"] = mapspace\n'),
])
def test_cache_key_without_engine_or_mapspace_fires(tmp_path, key, old):
    files = dict(_CACHE_FIXTURE)
    src = textwrap.dedent(files[_CACHE])
    assert old in src
    files[_CACHE] = src.replace(old, "}" if key == "backend" else "")
    root = mk_repo(tmp_path, files)
    findings = run_analysis(root, rules=["R-CACHE"])
    assert len(findings) == 1
    assert f"lacks {key!r}" in findings[0].message


def test_live_schema_pin_is_the_ports(live):
    from repro_torch.analysis.rules.cache_key import (_cache_format,
                                                      compute_key_schema,
                                                      load_pin, pin_path,
                                                      schema_hash)
    idx = live
    pin = load_pin(pin_path(idx))
    assert pin_path(idx) == REPO / PORT_SRC / "analysis" / \
        "cache_key_schema.json"
    schema = compute_key_schema(idx)
    assert pin["schema_hash"] == schema_hash(schema)
    assert pin["cache_format"] == _cache_format(idx)
    assert {"backend", "mapspace", "scorer"} <= set(schema["payload_keys"])


# ---------------------------------------------------------------------------
# R-REG fixtures
# ---------------------------------------------------------------------------
_STRATEGIES = """\
    STRATEGIES = {}

    def register(name):
        def deco(cls):
            STRATEGIES[name] = cls
            return cls
        return deco

    @register("alpha")
    class Alpha:
        pass

    @register("beta")
    class Beta:
        pass
"""

_PROGRESS = """\
    EVENT_KINDS = ("arch-started", "arch-finished")

    class ConsoleSink:
        def __call__(self, ev):
            if ev.kind == "arch-started":
                print(ev)
"""

_EMITTER = """\
    def run(stream):
        stream.emit("arch-started")
        stream.emit("arch-finished")
"""
def _reg(tmp_path, contract):
    files = {f"{PORT_SRC}/search/strategies.py": _STRATEGIES}
    if contract is not None:
        files[_CONTRACT] = contract
    return run_analysis(mk_repo(tmp_path, files), rules=["R-REG"])


def test_reg_registry_driven_contract_test_covers_all(tmp_path):
    assert _reg(tmp_path, """\
    from repro_torch.search.strategies import STRATEGIES

    def test_contract():
        for name in sorted(STRATEGIES):
            assert name
""") == []


def test_reg_parametrized_over_the_ports_registry_covers_all(tmp_path):
    assert _reg(tmp_path, """\
    import pytest
    import repro_torch.search as ts

    @pytest.mark.parametrize("name", sorted(ts.STRATEGIES))
    def test_contract(name):
        assert name
""") == []


@pytest.mark.parametrize("contract", [
    """\
    import pytest
    import repro.search as rs

    ALL = sorted(rs.STRATEGIES)

    @pytest.mark.parametrize("name", ALL)
    def test_contract(name):
        assert name
""",
    """\
    from repro.search.strategies import STRATEGIES

    def test_contract():
        for name in sorted(STRATEGIES):
            assert name
""",
    """\
    import repro_torch.search as ts

    def test_same_names():
        assert sorted(ts.STRATEGIES)
""",
], ids=["jax-registry-parametrized", "jax-registry-loop",
        "port-registry-not-driven"])
def test_reg_contract_over_another_registry_does_not_cover(tmp_path,
                                                           contract):
    """A test driven by the JAX package's registry, or one that only
    names the port's, proves nothing about what the port registers."""
    assert sorted(f.symbol for f in _reg(tmp_path, contract)) == \
        ["alpha", "beta"]


def test_reg_literal_coverage_gap_fires(tmp_path):
    findings = _reg(tmp_path, """\
    def test_contract():
        assert "alpha"
""")
    assert [f.symbol for f in findings] == ["beta"]


def test_reg_missing_contract_test_fires(tmp_path):
    msgs = [f.message for f in _reg(tmp_path, None)]
    assert len(msgs) == 1 and "missing" in msgs[0]


def test_reg_event_kinds_round_trip(tmp_path):
    root = mk_repo(tmp_path, {
        f"{PORT_SRC}/obs/progress.py": _PROGRESS.replace(
            '"arch-finished")', '"arch-finished", "dead-kind")'),
        f"{PORT_SRC}/search/driver.py": _EMITTER.replace(
            'emit("arch-finished")', 'emit("arch-typo")'),
    })
    msgs = [f.message for f in run_analysis(root, rules=["R-REG"])]
    assert any("arch-typo" in m and "not a declared" in m for m in msgs)
    assert any("dead-kind" in m and "nothing" in m for m in msgs)
    assert any("no branch" in m for m in msgs)


def test_reg_generic_sink_fallback_is_enough(tmp_path):
    progress = _PROGRESS.replace(
        "                print(ev)",
        "                print(ev)\n            else:\n"
        "                print(ev.kind)")
    root = mk_repo(tmp_path, {
        f"{PORT_SRC}/obs/progress.py": progress,
        f"{PORT_SRC}/search/driver.py": _EMITTER,
    })
    assert run_analysis(root, rules=["R-REG"]) == []


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------
def test_head_is_clean():
    """Tier-1 pin: `python -m repro_torch.analysis --strict` passes on
    the live repo against the port's empty baseline (all true positives
    are fixed, not grandfathered)."""
    baseline = REPO / "trimlint-torch-baseline.json"
    assert json.loads(baseline.read_text()) == {"findings": [],
                                                "version": 1}
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--root", str(REPO), "--baseline", str(baseline)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "trimlint: clean"


def test_mutation_dropped_cache_field_fires_r_cache(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/search/cache.py",
            '            "in_zf": round(wl.input_zero_frac, 9),\n', "")
    findings = run_analysis(root, rules=["R-CACHE"])
    assert findings and all(f.rule == "R-CACHE" for f in findings)
    assert any("Workload.input_zero_frac" in f.message for f in findings)
    assert any("CACHE_FORMAT" in f.message for f in findings)


def test_mutation_payload_key_without_bump_fires_r_cache(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/search/cache.py",
            '"scorer": scorer,', '"scorer": scorer, "extra": 1,')
    findings = run_analysis(root, rules=["R-CACHE"])
    assert len(findings) == 1
    assert "CACHE_FORMAT" in findings[0].message
    assert "bump" in findings[0].message


def test_mutation_dropped_engine_key_fires_r_cache(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/search/cache.py",
            '"scorer": scorer, "backend": backend,', '"scorer": scorer,')
    msgs = [f.message for f in run_analysis(root, rules=["R-CACHE"])]
    assert any("lacks 'backend'" in m for m in msgs)
    assert any("CACHE_FORMAT" in m for m in msgs)


def test_mutation_span_stripped_fires_r_sync(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/search/batch_frontier.py",
            "        with tr.span(\"fused.torch-group\", jobs=len(chunk), "
            "rows=rows):\n"
            "            _eval_group(sig, chunk, jobs, arrays, goal, out, "
            "dev)",
            "        _eval_group(sig, chunk, jobs, arrays, goal, out, dev)")
    findings = run_analysis(root, rules=["R-SYNC"])
    assert findings and all(f.rule == "R-SYNC" for f in findings)
    assert {f.symbol for f in findings} == {"_eval_group"}
    assert all(f.path.endswith("batch_frontier.py") for f in findings)
    msgs = " ".join(f.message for f in findings)
    assert "deferred-sync producer _dispatch_shards" in msgs
    assert "`_merge_shards()`" in msgs


def test_mutation_oracle_copy_out_of_span_fires_r_sync(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/core/batch_eval.py",
            "    with current_tracer().span(\"batch_eval.scores\", "
            "rows=n):\n"
            "        out = evaluate_batch(st, to_device(factors, dev),\n"
            "                             to_device(rank, dev), "
            "to_device(store, dev))\n"
            "        return (out[GOAL_KEY[goal]].cpu().numpy(),\n"
            "                out[\"valid\"].cpu().numpy())",
            "    out = evaluate_batch(st, to_device(factors, dev),\n"
            "                         to_device(rank, dev), "
            "to_device(store, dev))\n"
            "    return (out[GOAL_KEY[goal]].cpu().numpy(),\n"
            "            out[\"valid\"].cpu().numpy())")
    findings = run_analysis(root, rules=["R-SYNC"])
    assert len(findings) == 2
    assert {f.symbol for f in findings} == {"batch_scores_arrays"}
    assert all("`.cpu()`" in f.message for f in findings)


def test_mutation_unseeded_rng_fires_r_det(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/core/mapper.py",
            "np.random.default_rng(seed)", "np.random.default_rng()")
    findings = run_analysis(root, rules=["R-DET"])
    assert len(findings) == 1
    assert findings[0].rule == "R-DET"
    assert findings[0].symbol == "sample_index_rows"
    assert "unseeded" in findings[0].message


def test_mutation_unsorted_service_digest_fires_r_det(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/serve/dse_service.py",
            "json.dumps(self.signature(), sort_keys=True,\n"
            "                              default=str)",
            "json.dumps(self.signature(), default=str)")
    findings = run_analysis(root, rules=["R-DET"])
    assert len(findings) == 1
    assert findings[0].path.endswith("serve/dse_service.py")
    assert findings[0].symbol == "SearchQuery.digest"
    assert "sort_keys" in findings[0].message


def test_mutation_bogus_service_phase_fires_r_trace(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/serve/dse_service.py",
            'self.tracer.span("service.job", digest=',
            'self.tracer.span("service.job", phase=True, digest=')
    findings = run_analysis(root, rules=["R-TRACE"])
    assert len(findings) == 1
    assert findings[0].path.endswith("serve/dse_service.py")
    assert "not in the canonical" in findings[0].message


def test_mutation_typoed_service_event_kind_fires_r_reg(tmp_path):
    root = _copy_repo(tmp_path)
    _mutate(root, f"{PORT_SRC}/serve/dse_service.py",
            'job.emit("job-admitted"', 'job.emit("job-started"')
    msgs = [f.message for f in run_analysis(root, rules=["R-REG"])]
    assert any("'job-started'" in m and "not a declared" in m
               for m in msgs)
    assert any("'job-admitted'" in m and "nothing" in m for m in msgs)


def test_mutation_contract_over_jax_registry_fires_r_reg(tmp_path):
    """The port's contract test switched to the JAX package's registry
    (what tests/test_torch_search_parts.py parametrizes over) no longer
    covers the port's: every strategy not named literally fires."""
    root = _copy_repo(tmp_path)
    _mutate(root, _CONTRACT, "from repro_torch.search import (STRATEGIES, ",
            "from repro.search import STRATEGIES\n"
            "from repro_torch.search import (")
    findings = run_analysis(root, rules=["R-REG"])
    # exhaustive, random and bandit stay covered by the literal names of
    # the file's finite-proposer cases
    assert sorted(f.symbol for f in findings) == \
        ["anneal", "evolve", "hv-evolve"]


# ---------------------------------------------------------------------------
# engine / finding plumbing
# ---------------------------------------------------------------------------
def test_fingerprint_is_line_independent():
    a = Finding(rule="R-X", path="src/repro_torch/a.py", line=10, col=0,
                message="m", symbol="f")
    b = Finding(rule="R-X", path="src/repro_torch/a.py", line=99, col=4,
                message="m", symbol="f")
    c = Finding(rule="R-X", path="src/repro_torch/a.py", line=10, col=0,
                message="other", symbol="f")
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()


def test_get_rules_rejects_unknown_ids():
    assert {r.id for r in get_rules()} == \
        {"R-CACHE", "R-SYNC", "R-DET", "R-TRACE", "R-REG"}
    with pytest.raises(KeyError):
        get_rules(["R-NOPE"])


def test_rules_have_unique_ids_and_descriptions():
    ids = [r.id for r in RULES]
    assert len(ids) == len(set(ids))
    assert all(r.description for r in RULES)


def test_index_walks_the_port_not_the_jax_package(live):
    idx = live
    assert "search/batch_frontier.py" in idx.modules
    assert all(m.dotted.startswith("repro_torch")
               for m in idx.modules.values())
    assert not any(rel.startswith("analysis/") for rel in idx.modules)


# ---------------------------------------------------------------------------
# CLI: baseline round-trip, output formats, exit codes
# ---------------------------------------------------------------------------
_SCORE = f"{PORT_SRC}/core/score.py"


def test_cli_baseline_roundtrip(tmp_path, capsys):
    root = mk_repo(tmp_path, {_SCORE: SYNC_BAD})
    bl = tmp_path / "bl.json"
    argv = ["--root", str(root), "--rules", "R-SYNC",
            "--baseline", str(bl)]

    assert trimlint_main(argv) == 1                   # fresh finding
    assert trimlint_main(argv + ["--write-baseline"]) == 0
    data = json.loads(bl.read_text())
    assert data["version"] == 1 and len(data["findings"]) == 1
    assert data["findings"][0]["rule"] == "R-SYNC"

    assert trimlint_main(argv) == 0                   # suppressed
    assert trimlint_main(argv + ["--strict"]) == 0

    (root / _SCORE).write_text(textwrap.dedent(SYNC_GOOD_SPAN))
    assert trimlint_main(argv) == 0
    assert trimlint_main(argv + ["--strict"]) == 1
    out = capsys.readouterr().out
    assert "stale" in out


def test_cli_default_baseline_is_the_ports(tmp_path, capsys):
    from repro_torch.analysis import baseline
    assert baseline.DEFAULT_NAME == "trimlint-torch-baseline.json"
    root = mk_repo(tmp_path, {_SCORE: SYNC_BAD})
    argv = ["--root", str(root), "--rules", "R-SYNC"]
    assert trimlint_main(argv + ["--write-baseline"]) == 0
    assert (root / "trimlint-torch-baseline.json").is_file()
    assert not (root / "trimlint-baseline.json").exists()
    assert trimlint_main(argv + ["--strict"]) == 0


def test_cli_json_output(tmp_path, capsys):
    root = mk_repo(tmp_path, {_SCORE: SYNC_BAD})
    rc = trimlint_main(["--root", str(root), "--rules", "R-SYNC",
                        "--format", "json"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert report["version"] == 1
    assert len(report["findings"]) == 1
    f = report["findings"][0]
    assert f["rule"] == "R-SYNC" and f["path"] == _SCORE
    assert f["fingerprint"]


def test_cli_sarif_output(tmp_path, capsys):
    root = mk_repo(tmp_path, {_SCORE: SYNC_BAD})
    out = tmp_path / "out.sarif"
    rc = trimlint_main(["--root", str(root), "--rules", "R-SYNC",
                        "--format", "sarif", "--output", str(out)])
    assert rc == 1
    sarif = json.loads(out.read_text())
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "trimlint"
    assert any(r["id"] == "R-SYNC"
               for r in run["tool"]["driver"]["rules"])
    res = run["results"]
    assert len(res) == 1 and res[0]["ruleId"] == "R-SYNC"
    assert res[0]["partialFingerprints"]["trimlint/v1"]
    loc = res[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("score.py")


def test_cli_exit_codes(tmp_path, capsys):
    root = mk_repo(tmp_path, {_SCORE: SYNC_GOOD_SPAN})
    assert trimlint_main(["--root", str(root)]) == 0
    assert "clean" in capsys.readouterr().out
    assert trimlint_main(["--root", str(root),
                          "--rules", "R-BOGUS"]) == 2
    assert trimlint_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("R-CACHE", "R-SYNC", "R-DET", "R-TRACE", "R-REG"):
        assert rid in listed


def test_cli_update_schema_repins_after_a_format_bump(tmp_path, capsys):
    root = _copy_repo(tmp_path)
    cache = root / PORT_SRC / "search" / "cache.py"
    _mutate(root, f"{PORT_SRC}/search/cache.py",
            '"scorer": scorer,', '"scorer": scorer, "extra": 1,')
    argv = ["--root", str(root), "--rules", "R-CACHE"]
    assert trimlint_main(argv + ["--update-schema"]) == 2  # no bump: refused
    text = cache.read_text()
    fmt = next(line for line in text.splitlines()
               if line.startswith("CACHE_FORMAT = "))
    n = int(fmt.split("=")[1].split("#")[0])
    cache.write_text(text.replace(fmt, f"CACHE_FORMAT = {n + 1}", 1))
    assert trimlint_main(argv) == 1                    # pin is stale
    assert trimlint_main(argv + ["--update-schema"]) == 0
    assert trimlint_main(argv) == 0
    pin = json.loads((root / PORT_SRC / "analysis" /
                      "cache_key_schema.json").read_text())
    assert pin["cache_format"] == n + 1
    assert "repro_torch.analysis" in pin["_comment"]
