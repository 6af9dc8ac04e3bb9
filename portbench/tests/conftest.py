"""Fixtures of the benchmark's CPU tests: the checkout on `sys.path`, and a
copy of the benchmark in a temporary directory with two tiny cells added
by data files alone (a reduced dense and a reduced Mamba-2 configuration,
bf16, head dim 64 where the flash op needs it)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-dense": ("phi3-mini-3.8b", dict(n_layers=2, d_model=128, vocab=256,
                                          n_heads=2, n_kv_heads=1,
                                          head_dim=64, d_ff=256)),
    "tiny-ssm": ("mamba2-2.7b", dict(n_layers=2, d_model=128, vocab=256,
                                     d_state=16, ssm_headdim=16, chunk=16)),
}
#: limits of the tiny cells, set as the cells' are: above the bf16
#: program's readings over seeds, below the fp8 control's
#: (test_portbench_reference.py::test_control_fails_where_the_program_passes)
TINY_LIMITS = {"logit_rms_rel": 0.03, "logit_max_rel": 0.1}
#: two call shapes a cycle, [4, 16] and [2, 32]
TINY_TRAFFIC = {"loop": "closed", "clients": 1, "tokens": "uniform",
                "tokens_per_call": 64, "calls_per_cycle": 2,
                "lengths": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                            "min": 16, "max": 32, "multiple": 16}}


def add_tiny_cells(root: Path) -> None:
    """Add the tiny cells to the benchmark copy at `root` by new files and
    new `BENCHMARK.json` entries only."""
    bench = root / "portbench"
    man = json.loads((root / "BENCHMARK.json").read_text())
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    for name, (base, sizes) in TINY.items():
        cfg = json.loads((bench / "configs" / f"{base}.json").read_text())
        cfg["name"] = cfg["model"]["name"] = name
        cfg["model"].update(sizes)
        cfg["token_ids"] = sizes["vocab"]
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = f"{name}.tiny"
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            {"limits": TINY_LIMITS}))
        man["configs"].append({"name": name, "source": "a test", "reduced": [],
                               "file": f"portbench/configs/{name}.json",
                               "why": "a test"})
        man["workloads"].append({"name": cell, "config": name,
                                 "traffic": "tiny", "chips": 1,
                                 "why": "a test"})
        for m in man["per_layer"]:
            if any(base in w for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of `BENCHMARK.json` and `portbench/` (without its tests)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp_path


@pytest.fixture
def tiny_root(bench_copy) -> Path:
    add_tiny_cells(bench_copy)
    return bench_copy
