"""`BENCHMARK.json` against the benchmark's contract, and every cell's files
found by the names the manifest gives."""
from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT, add_tiny_cells

from portbench import harness

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head", "expand", "expansion", "experts_per_tok")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd == ["python3", "portbench/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs():
    cfgs = MANIFEST["configs"]
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank"))
            assert not any(w in k for w in WIDTH_WORDS), k
            assert k in body["published"] and k in body["assumed"]


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e, per = MANIFEST["end_to_end"], MANIFEST["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in e2e:                      # every cell reports every one
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:                      # each names the cells it reads in
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        assert m["workloads"] and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert any("mfu" in n for n in names)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_loads_and_reports_enough(cell):
    c = harness.load_cell(ROOT, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and c.chips == 1
    assert set(c.readers) == e2e | {m["name"] for m in c.per_layer}
    assert c.limits["limits"]
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert 0 < c.config["token_ids"] <= c.model["vocab"]
    assert set(c.reference.PARAMS(c.model)) >= {"embed", "ln_f.scale"}
    for b, s in harness.schedule(c.traffic):
        assert b * s <= c.traffic["tokens_per_call"]
        work = c.work(c.model, b, s)
        assert work["flops"] > 0 and (work["flash"] or work["ssd"])
    # the keys the reference takes as published are the ones cut
    entry = {x["name"]: x for x in MANIFEST["configs"]}[c.config["name"]]
    assert set(c.config.get("reference_keys", {})) <= set(entry["reduced"])


def test_cell_names_lists_every_workload():
    assert harness.cell_names(ROOT) == [w["name"]
                                        for w in MANIFEST["workloads"]]


def test_adding_files_adds_a_cell(bench_copy):
    before = {p: p.read_bytes() for p in (bench_copy / "portbench").rglob("*")
              if p.is_file()}
    add_tiny_cells(bench_copy)
    names = harness.cell_names(bench_copy)
    assert names[:len(MANIFEST["workloads"])] == \
        [w["name"] for w in MANIFEST["workloads"]]
    assert {"tiny-dense.tiny", "tiny-ssm.tiny"} <= set(names)
    for p, data in before.items():
        assert p.read_bytes() == data          # no file was edited
    cell = harness.load_cell(bench_copy, "tiny-ssm.tiny")
    assert cell.model["d_model"] == 128
    assert harness.schedule(cell.traffic) == [(4, 16), (2, 32)]
    assert "ssd_roofline.prefill" in cell.readers
