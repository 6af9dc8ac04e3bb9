"""The benchmark on the card: one short traced run of each cell through
`run.py` prints the contract's last line, correct, with every per-layer
metric of the cell and no share above 100%.  Marked `gpu`; skips on a host
without a card (decided inside the test).

    python -m pytest -q -m gpu portbench/tests/test_portbench_gpu.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from portbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", harness.cell_names(ROOT))
def test_short_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 17), "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert 0 < dev["busy_s"] <= dev["window_s"]
    want = {m["name"] for m in harness.load_cell(ROOT, cell).per_layer}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
