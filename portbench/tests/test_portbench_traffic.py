"""The traffic generator: each mix's call shapes worked by hand, the same
calls for every seed in another order, and the check's sample holding the
longest prompts."""
from __future__ import annotations

import json
import math
from collections import Counter

import pytest
import torch
from conftest import ROOT

from portbench import harness

TRAFFIC = ROOT / "portbench" / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_conv_2k_calls_worked_by_hand():
    # length-biased log-normal: log-mean ln 1020 + 0.5^2; call 0 takes the
    # quantile 1/16, z = -1.5341: 1020 e^(0.25 - 0.767) = 608.3 -> 640,
    # 8192 // 640 = 12 prompts; the top two quantiles pass 1920 and are cut
    mu = math.log(1020) + 0.25
    assert math.exp(mu - 0.5 * 1.5341) == pytest.approx(608.3, abs=0.1)
    assert harness.schedule(_mix("conv-2k")) == [
        (12, 640), (9, 896), (7, 1152), (6, 1280), (5, 1536), (4, 1792),
        (4, 1920), (4, 1920)]


def test_code_4k_calls_worked_by_hand():
    # log-mean ln 1500 + 0.8^2; z = -1.5341: 1500 e^(0.64 - 1.227) = 833.8
    # -> 896, 9 prompts; z = 0.4888: 4190 > 4096, cut
    mu = math.log(1500) + 0.64
    assert math.exp(mu - 0.8 * 1.5341) == pytest.approx(833.8, abs=0.1)
    assert math.exp(mu + 0.8 * 0.4888) > 4096
    assert harness.schedule(_mix("code-4k")) == [
        (9, 896), (5, 1408), (4, 2048), (3, 2560), (2, 3328), (2, 4096),
        (2, 4096), (2, 4096)]


@pytest.mark.parametrize("name", [p.stem for p in TRAFFIC.glob("*.json")])
def test_every_call_fits_the_budget_and_the_buckets(name):
    t = _mix(name)
    ln = t["lengths"]
    assert ln["max"] % ln["multiple"] == 0
    for b, s in harness.schedule(t):
        assert s % ln["multiple"] == 0 and ln["min"] <= s <= ln["max"]
        assert b * s <= t["tokens_per_call"] < (b + 1) * s


def test_every_seed_sends_the_same_calls_in_another_order():
    t = _mix("conv-2k")
    shapes = harness.schedule(t)
    k = len(shapes)
    orders = []
    for seed in (3, 2 ** 31 + 5, 2 ** 33 + 1):
        p = harness.prompts(seed, t, 100, "calls")
        got = [tuple(p(i).shape) for i in range(3 * k)]
        for c in range(3):
            assert Counter(got[c * k:(c + 1) * k]) == Counter(shapes)
        orders.append(got)
        again = harness.prompts(seed, t, 100, "calls")
        assert torch.equal(p(k + 2), again(k + 2))
        assert int(p(1).max()) < 100
    assert orders[0] != orders[1]


def test_check_sample_holds_the_first_longest_call():
    shapes = [(4, 16), (2, 32), (4, 16), (2, 32), (4, 16)] * 3
    for seed in range(20):
        got = harness.check_sample(seed, shapes)
        assert 1 in got and len(got) == harness.CHECKED_CALLS
        assert got == sorted(set(got))
    assert harness.check_sample(1, [(4, 16), (2, 32)]) == [0, 1]
    assert harness.check_sample(1, []) == []
