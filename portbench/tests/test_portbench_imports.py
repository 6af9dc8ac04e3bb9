"""Nothing the benchmark runs imports JAX or the JAX package (`repro`),
compared by whole top-level module names so that `repro_torch` passes, and
the references import nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

from portbench import harness

BENCH = ROOT / "portbench"


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench")                  # relative: within here
    return out


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_forbidden_names_are_compared_whole():
    found = harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "repro", "repro.models",
         "jax", "jax.numpy", "jaxlib.xla_client", "jaxtyping", "flax.linen",
         "flaxen", "torch", "reprolib"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                     "repro", "repro.models"]


def test_no_source_imports_jax_or_the_jax_package():
    assert _sources()
    for path in _sources():
        assert not harness.forbidden_modules(_imports(path)), path


def test_references_import_nothing_of_the_program():
    refs = list((BENCH / "reference").glob("*.py"))
    assert {p.stem for p in refs} >= {"plain", "dense", "mamba2"}
    for path in refs:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "torch",
                        "portbench"}, (path, tops)
        text = path.read_text()
        assert "repro_torch" not in text.replace("`repro_torch`", "")
        for m in _imports(path):
            if m.startswith("portbench"):
                assert m == "portbench.reference.plain", (path, m)


def test_a_run_loads_no_jax_module():
    """Load every cell and drive the tiny dense cell's timed path on the
    CPU in a fresh interpreter; then look at `sys.modules`."""
    code = f"""
import sys, time, json, shutil, tempfile
from pathlib import Path
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r},
                {str(BENCH / 'tests')!r}]
import torch
from portbench import harness
from conftest import add_tiny_cells
root = Path(tempfile.mkdtemp())
shutil.copy({str(ROOT / 'BENCHMARK.json')!r}, root / "BENCHMARK.json")
shutil.copytree({str(BENCH)!r}, root / "portbench",
                ignore=shutil.ignore_patterns("tests", "__pycache__"))
add_tiny_cells(root)
for name in harness.cell_names(root):
    harness.load_cell(root, name)
cell = harness.load_cell(root, "tiny-ssm.tiny")
res, _ = harness.run(cell, 3, 0.2, True, torch.device("cpu"),
                     time.perf_counter())
shutil.rmtree(root)
print(json.dumps([res["correct"], harness.forbidden_modules(sys.modules),
                  "repro_torch" in sys.modules]))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, found, ported = __import__("json").loads(
        p.stdout.strip().splitlines()[-1])
    assert correct and found == [] and ported
