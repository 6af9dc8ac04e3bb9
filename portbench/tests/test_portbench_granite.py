"""The granite-4.0-h-small cell on the CPU: its configuration and work
count at full size, and a tiny copy of it (`tiny-granite.tiny`, added by
data files alone, from conftest's helpers) run through the harness: the
float32 program equals `reference/granite_hybrid.py`, the bf16 program
passes the tiny limits where the float8 control fails them, a run is
`correct`, and its traced run reads the MoE's metrics."""
from __future__ import annotations

import dataclasses
import json
import math
import time

import pytest
import torch
from conftest import ROOT, TINY_TRAFFIC

from portbench import harness
from portbench.roofline import PEAK_BF16_FLOP_PER_S, flash_work

CELL = "granite-4.0-h-small.code-4k"
TINY = "tiny-granite.tiny"
#: the tiny copy: 4 layers (Mamba2, attention, Mamba2, Mamba2), d_model
#: 128, 2/1 heads of 64 at scale 1/64, 8 experts of 32, top 3, a shared
#: expert of 64; every multiplier as published
TINY_MODEL = dict(n_layers=4, d_model=128, vocab=256, n_heads=2,
                  n_kv_heads=1, head_dim=64, attention_multiplier=1 / 64,
                  d_state=16, ssm_heads=16, ssm_headdim=16, chunk=16,
                  n_experts=8, top_k=3, d_expert=32, d_shared=64,
                  layer_types=["mamba", "attention", "mamba", "mamba"])
#: the tiny cell's limits, set as the cell's are: above the bf16 program's
#: readings over seeds, below the float8 control's
TINY_LIMITS = {"logit_rms_rel": 0.03, "logit_max_rel": 0.1}


@pytest.fixture
def granite_root(bench_copy):
    """The benchmark copy with `tiny-granite.tiny` added by new files and
    new `BENCHMARK.json` entries only."""
    bench = bench_copy / "portbench"
    man = json.loads((bench_copy / "BENCHMARK.json").read_text())
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    cfg = json.loads((bench / "configs"
                      / "granite-4.0-h-small.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "tiny-granite"
    cfg["model"].update(TINY_MODEL)
    cfg["token_ids"] = TINY_MODEL["vocab"]
    (bench / "configs" / "tiny-granite.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{TINY}.json").write_text(json.dumps(
        {"limits": TINY_LIMITS}))
    man["configs"].append({"name": "tiny-granite", "source": "a test",
                           "reduced": [], "why": "a test",
                           "file": "portbench/configs/tiny-granite.json"})
    man["workloads"].append({"name": TINY, "config": "tiny-granite",
                             "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in man["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append(TINY)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(man))
    return bench_copy


def _outputs(cell, seed, dtype, calls=2):
    """(the program's logits, the reference's) for `calls` prompts."""
    name = str(dtype).split(".")[-1]
    model = dict(cell.model, param_dtype=name, compute_dtype=name)
    cell = dataclasses.replace(cell, config=dict(cell.config, model=model))
    w = harness.make_weights(cell.reference.PARAMS(model), dtype, seed,
                             torch.device("cpu"))
    call = harness.program(model, w)
    prompt = harness.prompts(seed, cell.traffic, model["vocab"], "calls")
    return cell, w, prompt, [(call(prompt(i)), harness.reference_logits(
        cell, w, prompt(i))) for i in range(calls)]


def test_the_cell_holds_the_catalog_config_as_run():
    """The file's top-level keys are the published config.json's, but the
    one cut (the SSD chunk); the program's model matches them."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "granite-4.0-h-small.json").read_text())
    pub, m = cfg["published"], cfg["model"]
    assert {k: cfg[k] for k in pub} == dict(pub, mamba_chunk_size=128)
    assert cfg["reduced"] == ["mamba_chunk_size"]
    assert m["chunk"] == cfg["mamba_chunk_size"]
    assert m["layer_types"] == pub["layer_types"]
    assert [i for i, k in enumerate(m["layer_types"]) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (m["n_layers"], m["d_model"], m["vocab"]) == (
        pub["num_hidden_layers"], pub["hidden_size"], pub["vocab_size"])
    assert (m["n_heads"], m["n_kv_heads"], m["head_dim"]) == (
        pub["num_attention_heads"], pub["num_key_value_heads"],
        pub["hidden_size"] // pub["num_attention_heads"])
    assert (m["n_experts"], m["top_k"], m["d_expert"], m["d_shared"]) == (
        pub["num_local_experts"], pub["num_experts_per_tok"],
        pub["intermediate_size"], pub["shared_intermediate_size"])
    assert (m["ssm_heads"], m["ssm_headdim"], m["d_state"], m["d_conv"],
            m["expand"], m["ssm_ngroups"]) == (
        pub["mamba_n_heads"], pub["mamba_d_head"], pub["mamba_d_state"],
        pub["mamba_d_conv"], pub["mamba_expand"], pub["mamba_n_groups"])
    for k in ("embedding_multiplier", "residual_multiplier",
              "logits_scaling", "attention_multiplier"):
        assert m[k] == pub[k]
    assert m["rope"] == "none" and pub["position_embedding_type"] == "nope"
    assert m["capacity_factor"] == 0 and m["tie_embeddings"]


def test_full_size_parameters_and_work():
    """32.2B parameters (64.4 GB in bf16), ~8.8B active; a call of 8192
    tokens ~138-140 TFLOP, 4 attention layers and 36 scans."""
    from repro_torch.configs.base import ModelConfig
    cell = harness.load_cell(ROOT, CELL)
    m = cell.model
    params = cell.reference.PARAMS(m)
    n = sum(math.prod(shape) for shape, _ in params.values())
    assert 32.2e9 < n < 32.3e9 and 2 * n < 0.81 * 80e9
    mc = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in m.items()})
    assert abs(mc.param_count() - n) < 0.001 * n
    assert 8.7e9 < mc.active_param_count() < 8.9e9
    w = cell.work(m, 2, 4096)
    assert 138e12 < w["flops"] < 141e12
    assert w["flash"] == [(2, 4096, 32, 8, 128)] * 4
    assert w["ssd"] == [(2, 4096, 128, 64, 1, 128, 128)] * 36
    assert w["moe"] == [(8192, 10, 4096, 768, 72)] * 40
    # the attention layers' share, as flash_work counts it
    assert flash_work(2, 4096, 32, 8, 128)[0] * 4 < 0.01 * w["flops"]


def test_grouped_work_and_bound():
    from portbench.roofline.granite_hybrid import grouped_bound_s, \
        grouped_work
    # 2 rows (1 token x top 2), d 4, f 3, 5 experts: 3 products of 2 x 4 x
    # 3 multiply-adds; rows 3 x 2 x 4, weights 3 x 5 x 4 x 3, outputs and
    # activations 3 x 2 x 3 elements, 2 bytes each
    assert grouped_work(1, 2, 4, 3, 5) == (144, 2 * (24 + 180 + 18))
    t, by = grouped_bound_s(8192, 10, 4096, 768, 72)
    assert by == "operations"
    assert t == pytest.approx(6 * 81920 * 4096 * 768 / PEAK_BF16_FLOP_PER_S)


def test_float32_program_equals_the_reference(granite_root):
    cell = harness.load_cell(granite_root, TINY)
    _, _, _, out = _outputs(cell, 2 ** 31 + 7, torch.float32)
    for prog, ref in out:
        got = harness.compare(prog, ref)
        assert got["logit_rms_rel"] < 2e-5 and got["logit_max_rel"] < 1e-4


def test_control_fails_where_the_program_passes(granite_root):
    """Three seeds: every bf16 program reading under the tiny limits, every
    float8 control reading over them, three times apart."""
    cell = harness.load_cell(granite_root, TINY)
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


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_run_of_the_tiny_cell_is_correct(granite_root, trace):
    cell = harness.load_cell(granite_root, TINY)
    # a window long enough for the p90's calls on a loaded host
    result, _ = harness.run(cell, 2 ** 31 + 99, 3.0, trace,
                            torch.device("cpu"), time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"prefill_tokens_per_s",
                                          "prefill_p90_ms", "setup_s"}
        return
    got = result["metrics"]
    # the CPU takes the plain loop: no grouped launch, no device kernel
    assert got["moe_grouped_calls.prefill"]["value"] == 0
    assert "moe_roofline.prefill" not in got
    assert got["ssd_tc_calls.prefill"]["value"] == 0
    assert "mfu.prefill" in got


def test_moe_roofline_reads_the_grouped_kernels_by_name():
    from portbench.trace import Trace
    cell = harness.load_cell(ROOT, CELL)
    read = cell.readers["moe_roofline.prefill"]
    name = "void cutlass::device_kernel<cutlass::gemm::kernel::" \
        "GemmUniversal<cutlass::gemm::GroupProblemShape<cute::tuple<int>>>>"
    per_call = 3 * 40 * 1e-3                    # 120 launches of 1 ms
    device = [(name, i * 1e-3, (i + 1) * 1e-3) for i in range(120)] \
        + [("nvjet_tst_192x192", 0.2, 0.3)]
    tr = Trace(calls=1, device=device, host=[], t0=0.0, t1=0.4)
    r = harness.Readings(cell, 1.0, harness.Window(), tr, [(2, 4096)])
    bound = 40 * 6 * 81920 * 4096 * 768 / PEAK_BF16_FLOP_PER_S
    assert read(r) == pytest.approx(100 * bound / per_call)
    assert read(harness.Readings(cell, 1.0, harness.Window(), None)) is None
