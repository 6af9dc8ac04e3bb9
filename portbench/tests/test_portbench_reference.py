"""The plain references against the program at reduced sizes on the CPU
(where the program's flash and SSD ops compute their plain versions), the
SSD scan against its recurrence, and the control: the reference with its
weight products in float8 fails the limits that the bf16 program passes."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import TINY_LIMITS

from portbench import harness
from portbench.reference import plain

CELLS = ["tiny-dense.tiny", "tiny-ssm.tiny"]


def _outputs(cell, seed, dtype, calls=2):
    """(the program's logits, the reference's) for `calls` prompts."""
    model = dict(cell.model, param_dtype=str(dtype).split(".")[-1],
                 compute_dtype=str(dtype).split(".")[-1])
    cell = dataclasses.replace(cell, config=dict(cell.config, model=model))
    w = harness.make_weights(cell.reference.PARAMS(model), dtype, seed,
                             torch.device("cpu"))
    call = harness.program(model, w)
    prompt = harness.prompts(seed, cell.traffic, model["vocab"], "calls")
    out = []
    for i in range(calls):
        out.append((call(prompt(i)), harness.reference_logits(
            cell, w, prompt(i))))
    return cell, w, prompt, out


@pytest.mark.parametrize("name", CELLS)
def test_float32_program_equals_the_reference(tiny_root, name):
    cell = harness.load_cell(tiny_root, name)
    _, _, _, out = _outputs(cell, 2 ** 31 + 7, torch.float32)
    for prog, ref in out:
        got = harness.compare(prog, ref)
        assert got["logit_rms_rel"] < 2e-5 and got["logit_max_rel"] < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(tiny_root, name):
    """Three seeds each: every bf16 program reading under the tiny cells'
    limits, every float8 control reading over them, three times apart."""
    cell = harness.load_cell(tiny_root, name)
    prog, ctrl = {}, {}
    for seed in (11, 2 ** 31 + 12, 3_000_000_013):
        cell_b, w, prompt, out = _outputs(cell, seed, torch.bfloat16)
        for i, (p, ref) in enumerate(out):
            prog = harness.worst(prog, harness.compare(p, ref))
            low = harness.reference_logits(cell_b, w, prompt(i), "fp8")
            got = harness.compare(low, ref)
            ctrl = {k: min(ctrl.get(k, v), v) for k, v in got.items()}
    for k, lim in TINY_LIMITS.items():
        assert prog[k] < lim < ctrl[k], (k, prog[k], ctrl[k])
        assert ctrl[k] > 3 * prog[k]


def test_ssd_equals_its_recurrence():
    g = torch.Generator().manual_seed(0)
    b, t, h, p, grp, n = 2, 12, 4, 3, 2, 5
    x = torch.randn(b, t, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, t, h, generator=g, dtype=torch.float64)
    a = -torch.rand(h, generator=g, dtype=torch.float64) * 4
    bm = torch.randn(b, t, grp, n, generator=g, dtype=torch.float64)
    cm = torch.randn(b, t, grp, n, generator=g, dtype=torch.float64)
    y = plain.ssd(x, dt, a, bm, cm, chunk=4)
    state = torch.zeros(b, h, n, p, dtype=torch.float64)
    rep = h // grp
    for s in range(t):
        bh = bm[:, s].repeat_interleave(rep, 1)               # [B, H, N]
        ch = cm[:, s].repeat_interleave(rep, 1)
        state = state * torch.exp(dt[:, s] * a)[..., None, None] \
            + torch.einsum("bhn,bh,bhp->bhnp", bh, dt[:, s], x[:, s])
        torch.testing.assert_close(
            y[:, s], torch.einsum("bhn,bhnp->bhp", ch, state))


def test_causal_attention_equals_a_loop():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 5, 4, 8, generator=g)
    k, v = torch.randn(2, 1, 5, 2, 8, generator=g)
    out = plain.causal_attention(q, k, v)
    for i in range(5):
        for hh in range(4):
            s = q[0, i, hh] @ k[0, :i + 1, hh // 2].T / 8 ** 0.5
            want = torch.softmax(s, -1) @ v[0, :i + 1, hh // 2]
            torch.testing.assert_close(out[0, i, hh], want)


def test_sliding_window_masks_only_beyond_it():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 6, 2, 8, generator=g)
    k, v = torch.randn(2, 1, 6, 1, 8, generator=g)
    full = plain.causal_attention(q, k, v)
    # a window as long as the prompt masks nothing
    torch.testing.assert_close(plain.causal_attention(q, k, v, 6), full)
    out = plain.causal_attention(q, k, v, 3)
    torch.testing.assert_close(out[:, :3], full[:, :3])
    for i in range(3, 6):
        for hh in range(2):
            s = q[0, i, hh] @ k[0, i - 2:i + 1, 0].T / 8 ** 0.5
            want = torch.softmax(s, -1) @ v[0, i - 2:i + 1, 0]
            torch.testing.assert_close(out[0, i, hh], want)


def test_reference_takes_the_published_window(tiny_root):
    """The program runs phi3 with no window, the reference with the
    released 2047: equal at the tiny cell's lengths, and a window that
    binds turns the check's numbers far past the limits."""
    cell = harness.load_cell(tiny_root, "tiny-dense.tiny")
    assert cell.model["sliding_window"] == 0
    assert cell.reference_model["sliding_window"] == 2047
    c32, w, prompt, out = _outputs(cell, 2 ** 31 + 3, torch.float32)
    binds = dataclasses.replace(c32, config=dict(
        c32.config, reference_keys={"sliding_window": 4}))
    for i, (prog, ref) in enumerate(out):
        assert harness.compare(prog, ref)["logit_rms_rel"] < 2e-5
        got = harness.compare(prog, harness.reference_logits(
            binds, w, prompt(i)))
        assert got["logit_rms_rel"] > 10 * TINY_LIMITS["logit_rms_rel"]


def test_fp8_rounding_and_float32_exact():
    t = torch.tensor([0.1, -3.0, 448.0 * 2])
    r = plain.fp8_round(t)
    assert r[2] == t[2] and (r - t).abs().max() < 0.1 * t.abs().max()
    before = torch.backends.cuda.matmul.allow_tf32
    with plain.float32_exact():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 == before
