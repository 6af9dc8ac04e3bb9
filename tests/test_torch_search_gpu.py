"""The port's search driver on the card: `run_search` with the kernel
engine ("cuda") against the oracle engine ("torch"), streamed rounds
against synchronous ones, and `fused_launch`/`fused_collect` against
`fused_best`.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_search_gpu.py

AlexNet-CIFAR at batch 4 over four spatial designs, no-bypass mapspaces of
up to 400 mappings (so every job is kernel-eligible).  Equal means the same
best coordinates and goal value, history rows and frontier: the kernel
and the oracle agree on validity exactly and the winners are re-scored by
the same float64 scalar evaluator."""
import pytest
import torch

import repro_torch.core as tc
import repro_torch.search as ts
from repro_torch.kernels.mapspace_eval import kernel

TASK = tc.analyze(tc.alexnet_cifar(batch_size=4))
CFG = tc.MapperConfig(max_mappings=400, seed=0, enable_bypass=False)
ARCHS = dict(num_pes=(64, 256), rf_words=(128,),
             gbuf_words=(16 * 1024, 64 * 1024), bits=16)


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _search(dev, engine, **kw):
    kernel.reset_launches()
    report = ts.run_search(TASK, ts.ArchSpace.spatial(**ARCHS), cfg=CFG,
                           backend=engine, device=dev, round_size=2, **kw)
    return report, dict(kernel.LAUNCHES)


def _same(a, b):
    hist = lambda r: [(row["step"], row["coords"], row["value"],
                       row["objectives"], row["feasible"])
                      for row in r.history]
    assert a.best_coords == b.best_coords
    assert a.goal_value() == b.goal_value()
    assert hist(a) == hist(b)
    assert sorted(a.pareto.values()) == sorted(b.pareto.values())
    assert a.hypervolume_curve() == b.hypervolume_curve()
    for wa, wb in zip(a.best.per_workload, b.best.per_workload):
        assert wa.mapping.factors == wb.mapping.factors


@pytest.mark.gpu
@pytest.mark.parametrize("batching, launched", [("fused", "multi"),
                                                ("per-arch", "single")])
def test_run_search_cuda_equals_torch(card, batching, launched):
    got, launches = _search(card, "cuda", batching=batching)
    want, ref_launches = _search(card, "torch", batching=batching)
    assert launches[launched] > 0
    assert ref_launches["single"] == ref_launches["multi"] == 0
    _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_streamed_equals_synchronous(card, engine):
    streamed, _ = _search(card, engine, overlap=True, trace=True)
    sync, _ = _search(card, engine, overlap=False, trace=True)
    assert streamed.overlap and not sync.overlap
    assert "device-wait" in streamed.phase_times
    _same(streamed, sync)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("enable_bypass", [False, True])
def test_fused_launch_collect_equals_fused_best(card, engine,
                                                enable_bypass):
    cfg = tc.MapperConfig(max_mappings=400, seed=0,
                          enable_bypass=enable_bypass)
    distinct = {w.dims: w for w in TASK.intra}.values()
    jobs = [ts.MapspaceJob(tag=(hw.name, wl.name), hw=hw, workload=wl,
                           packed=tc.build_packed_mapspace(wl, hw, cfg))
            for hw in tc.generate_arch_space(**ARCHS) for wl in distinct]
    want = ts.fused_best(jobs, "edp", device=card, backend=engine)
    pending = ts.fused_launch(jobs, "edp", device=card, backend=engine)
    for g in pending.groups:                 # oracle scores stay on the card
        for scores, valid in g.pend:         # one (scores, valid) a shard
            assert scores.device.type == valid.device.type == "cuda"
    got = ts.fused_collect(pending)
    assert [(b.tag, b.index, b.value) for b in got] == \
        [(b.tag, b.index, b.value) for b in want]
