"""A run on the CPU at a tiny cell, past the harness's look for a card,
with the timed path broken underneath: `correct` comes out false for each
fault a prefill cell can have (half of the batch left out, an answer
altered where it is produced, a non-finite answer) and for the control in
the program's place, and true unbroken.
The faults of training (a step that returns its state unchanged) and of
several chips (the exchange left out) do not exist in these one-chip
prefill cells.  And `run.py` refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

from portbench import harness


def _half_batch(out):
    """The second half of the rows left out, the mean of the rest in their
    place."""
    h = out.shape[0] // 2
    out = out.clone()
    out[h:] = out[:h].float().mean(0).to(out.dtype)
    return out


def _swapped_answer(out):
    """Row 0 answers with row 1's logits."""
    out = out.clone()
    out[0] = out[1]
    return out


def _raised_token(out):
    """Row 0's top logit raised by twice the row's spread."""
    out = out.clone()
    i = out[0].float().argmax()
    out[0, i] += 2 * out[0].float().std()
    return out


def _not_finite(out):
    out = out.clone()
    out[0, 0] = float("nan")
    return out


def _run(root, cell, monkeypatch, fault=None, trace=False):
    program = harness.program
    if fault is not None:
        def broken(model_cfg, weights):
            call = program(model_cfg, weights)
            return lambda tokens: fault(call(tokens))
        monkeypatch.setattr(harness, "program", broken)
    c = harness.load_cell(root, cell)
    return harness.run(c, 2 ** 31 + 99, 0.3, trace, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-ssm.tiny"])
def test_unbroken_run_is_correct(tiny_root, monkeypatch, cell):
    result, lines = _run(tiny_root, cell, monkeypatch)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 3
    assert list(result)[-1] == "check"
    for k, v in result["check"].items():
        assert v["value"] <= v["limit"]
        assert any(line.startswith(f"check {k} ") for line in lines)
    assert set(result["metrics"]) == {"prefill_tokens_per_s",
                                      "prefill_p90_ms", "setup_s"}


@pytest.mark.parametrize("fault", [_half_batch, _swapped_answer,
                                   _raised_token, _not_finite])
@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-ssm.tiny"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    result, _ = _run(tiny_root, cell, monkeypatch, fault)
    assert result["correct"] is False
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 99, 3_000_000_021])
@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-ssm.tiny"])
def test_control_in_the_programs_place_is_not_correct(tiny_root, monkeypatch,
                                                     cell, seed):
    """The reference with its weight products in float8 as the timed path:
    the run's own check turns `correct` false."""
    c = harness.load_cell(tiny_root, cell)

    def control(model_cfg, weights):
        return lambda tokens: harness.reference_logits(c, weights, tokens,
                                                       "fp8")
    monkeypatch.setattr(harness, "program", control)
    result, _ = harness.run(c, seed, 0.3, False, torch.device("cpu"),
                            time.perf_counter())
    assert result["correct"] is False and result["failed"] == 0
    assert any(v["value"] > v["limit"] for v in result["check"].values())


def test_traced_run_reports_per_layer_metrics(tiny_root, monkeypatch):
    result, _ = _run(tiny_root, "tiny-dense.tiny", monkeypatch, trace=True)
    assert result["correct"]
    assert {"host_enqueue_ms.prefill", "mfu.prefill"} <= \
        set(result["metrics"])
    assert "prefill_tokens_per_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _cli(cwd, *args):
    """`run.py` in a process that sees no card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    p = _cli(ROOT, "--workload", "phi3-mini-3.8b.conv-2k", "--seed",
             str(2 ** 31 + 5), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_without_the_program_exits_non_zero(bench_copy):
    p = _cli(bench_copy, "--workload", "mamba2-2.7b.code-4k", "--seed",
             "1", "--seconds", "1", "--trace", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""
