"""The port's spans on the profiler's clock: a recording `Tracer` opens each
span as a `torch.profiler` range while the profiler records, and the
model's prefill `forward` records the spans of `obs.MODEL_SPANS` into the
ambient tracer, covering every ATen operator of the call, with logits
unchanged.  CPU only; torch and `repro_torch` only."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import reduced_config
from repro_torch.models import forward, init_model
from repro_torch.obs import (MODEL_SPANS, NULL_TRACER, Tracer, activate,
                             current_tracer)
from repro_torch.obs import trace as obs_trace

CPU = [ProfilerActivity.CPU]


def _ranges(prof):
    """{name: [event]} of the profiler's `record_function` ranges."""
    out = {}
    for e in prof.events():
        if e.is_user_annotation:
            out.setdefault(e.name, []).append(e)
    return out


def _parent_range(e):
    p = e.cpu_parent
    while p is not None and not p.is_user_annotation:
        p = p.cpu_parent
    return p.name if p is not None else None


def test_recording_tracer_opens_one_profiler_range_a_span():
    tr = Tracer()
    with profile(activities=CPU) as prof:
        with tr.span("outer"):
            with tr.span("inner", rows=4):
                torch.ones(8).add_(1)
            with tr.span("inner"):
                pass
    ranges = _ranges(prof)
    assert sorted((n, len(v)) for n, v in ranges.items()) == \
        [("inner", 2), ("outer", 1)]
    assert [_parent_range(e) for e in ranges["inner"]] == ["outer", "outer"]
    assert _parent_range(ranges["outer"][0]) is None
    spans = {s.name: s for s in tr.buffer.snapshot()}
    assert spans["inner"].depth == 1 and spans["outer"].depth == 0
    assert all(s.t1 is not None for s in tr.buffer.snapshot())


def test_recording_tracer_opens_no_range_without_a_profiler(monkeypatch):
    made = []
    tr = Tracer()
    real = tr._profiler.record_function

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(tr._profiler, "record_function", counting)
    with tr.span("a"):
        with tr.span("b"):
            torch.ones(4).sum()
    assert made == [] and len(tr.buffer) == 2
    with profile(activities=CPU):
        with tr.span("c"):
            pass
    assert made == ["c"]


def test_span_range_closes_when_its_body_raises():
    tr = Tracer()
    with profile(activities=CPU) as prof:
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        with tr.span("after"):
            pass
    ranges = _ranges(prof)
    assert set(ranges) == {"boom", "after"}
    assert _parent_range(ranges["after"][0]) is None


def test_null_tracer_stays_the_shared_noop_under_a_profiler():
    with profile(activities=CPU) as prof:
        a = NULL_TRACER.span("model.forward")
        b = NULL_TRACER.span("norm", layer=3)
        with a:
            with b:
                torch.ones(4).sum()
    assert a is b
    assert _ranges(prof) == {}
    assert current_tracer() is NULL_TRACER


def test_model_spans_are_unique_names():
    assert len(set(MODEL_SPANS)) == len(MODEL_SPANS)
    assert MODEL_SPANS[0] == "model.forward"
    assert not set(MODEL_SPANS) & set(obs_trace.PHASES)


#: the reduced config of each family and the spans its prefill must record
FAMILIES = {
    "phi3-mini-3.8b": {"attn", "attn.rope", "attn.core", "mlp"},
    "mamba2-2.7b": {"ssm", "ssm.conv", "ssm.scan", "ssm.gate"},
    "zamba2-2.7b": {"ssm", "ssm.conv", "ssm.scan", "ssm.gate", "attn",
                    "attn.rope", "attn.core", "mlp"},
    "granite-moe-1b-a400m": {"attn", "attn.rope", "attn.core", "mlp"},
    "minicpm3-4b": {"attn", "attn.rope", "attn.core", "mlp"},
    # no RoPE: its "attn.rope" spans hold no operator
    "whisper-small": {"attn", "attn.rope", "attn.core", "mlp"},
}
COMMON = {"model.forward", "model.embed", "model.block", "norm",
          "model.head"}


def _model(arch):
    cfg = reduced_config(arch)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 35, cfg.d_model, generator=gen)
    return cfg, model, batch


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_prefill_spans_cover_every_operator(arch):
    """Under an activated `Tracer` and a CPU profiler, every ATen operator
    of `forward` lies under a span of `MODEL_SPANS` other than the call's
    own, every recorded span is one of them, and the logits are
    bit-equal to a call with tracing off."""
    cfg, model, batch = _model(arch)
    with torch.no_grad():
        off = forward(model, cfg, batch, logits_mode="last")
        tr = Tracer()
        with profile(activities=CPU) as prof, activate(tr):
            on = forward(model, cfg, batch, logits_mode="last")
    assert torch.equal(on, off)
    names = {s.name for s in tr.buffer.snapshot()}
    assert names <= set(MODEL_SPANS)
    assert names == COMMON | FAMILIES[arch]
    call = [s for s in tr.buffer.snapshot() if s.name == "model.forward"]
    assert len(call) == 1 and call[0].attrs == {
        "family": cfg.family, "B": 2, "S": 32}
    blocks = [s for s in tr.buffer.snapshot() if s.name == "model.block"]
    assert all(s.parent == call[0].index for s in blocks)
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and not (e.cpu_parent and e.cpu_parent.name.startswith("aten::"))]
    assert ops
    owners = {_parent_range(e) for e in ops}
    assert owners <= set(MODEL_SPANS) - {"model.forward"}, owners
    ranges = _ranges(prof)
    assert {n: len(v) for n, v in ranges.items()} == \
        {n: sum(s.name == n for s in tr.buffer.snapshot()) for n in names}


def test_prefill_records_nothing_without_an_active_tracer():
    cfg, model, batch = _model("mamba2-2.7b")
    with torch.no_grad(), profile(activities=CPU) as prof:
        forward(model, cfg, batch, logits_mode="last")
    assert not set(_ranges(prof)) & set(MODEL_SPANS)


def test_prefill_spans_nest_as_the_layers_do():
    cfg, model, batch = _model("mamba2-2.7b")
    tr = Tracer()
    with torch.no_grad(), activate(tr):
        forward(model, cfg, batch, logits_mode="last")
    spans = tr.buffer.snapshot()
    parent = {s.index: spans[s.parent].name if s.parent is not None
              else None for s in spans}
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, set()).add(parent[s.index])
    assert by_name["model.forward"] == {None}
    assert by_name["model.embed"] == {"model.forward"}
    assert by_name["model.block"] == {"model.forward"}
    assert by_name["norm"] == {"model.block", "model.forward"}
    assert by_name["ssm"] == {"model.block"}
    assert by_name["ssm.conv"] == by_name["ssm.scan"] == \
        by_name["ssm.gate"] == {"ssm"}
    assert by_name["model.head"] == {"model.forward"}
    assert [s.attrs["layer"] for s in spans if s.name == "model.block"] \
        == list(range(cfg.n_layers))


def test_hybrid_moe_prefill_spans():
    """The `hybrid_moe` family (Mamba2 and attention layers, each followed
    by a dropless MoE): its prefill records the Mamba2, attention and MoE
    spans, the MoE's five inside "mlp", every operator under a span, and
    the logits bit-equal to a call with tracing off."""
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(
        name="tiny-hybrid-moe", family="hybrid_moe", n_layers=2,
        d_model=64, vocab=128, n_heads=4, n_kv_heads=2, head_dim=16,
        rope="none", n_experts=4, top_k=2, n_shared_experts=1, d_expert=32,
        d_shared=48, capacity_factor=0.0, d_state=16, ssm_headdim=16,
        chunk=16, layer_types=("mamba", "attention"),
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, attention_multiplier=1 / 16,
        param_dtype="float32", compute_dtype="float32")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    with torch.no_grad():
        off = forward(model, cfg, batch, logits_mode="last")
        tr = Tracer()
        with profile(activities=CPU) as prof, activate(tr):
            on = forward(model, cfg, batch, logits_mode="last")
    assert torch.equal(on, off)
    spans = tr.buffer.snapshot()
    moe_spans = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                 "moe.shared"}
    assert {s.name for s in spans} == COMMON | moe_spans | {
        "ssm", "ssm.conv", "ssm.scan", "ssm.gate", "attn", "attn.rope",
        "attn.core", "mlp"}
    assert {spans[s.parent].name for s in spans if s.name in moe_spans} \
        == {"mlp"}
    assert sum(s.name == "moe.experts" for s in spans) == cfg.n_layers
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and not (e.cpu_parent and e.cpu_parent.name.startswith("aten::"))]
    owners = {_parent_range(e) for e in ops}
    assert owners <= set(MODEL_SPANS) - {"model.forward"}, owners
    assert moe_spans <= owners
