"""The port's DSE service and fused shard plan on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_service_gpu.py

AlexNet-CIFAR at batch 4 over four spatial designs, no-bypass mapspaces of
up to 400 mappings (every job kernel-eligible).  Equal means the same best
coordinates and goal value, history rows and frontier: the kernel and the
oracle agree on validity exactly and winners are re-scored by the same
float64 scalar evaluator.
  * the "cuda" and "torch" engines give the same service result;
  * two jobs run at once on two workers give the results they give alone,
    and the kernel's launch counts are exactly the sum of theirs alone;
  * a forced two-shard plan over (cuda:0, cuda:0) is bit-equal to the
    unsharded call for the oracle and the kernel groups.
"""
import pytest
import torch

import repro_torch.core as tc
import repro_torch.search as ts
from repro_torch.kernels.mapspace_eval import kernel
from repro_torch.search import batch_frontier as bf
from repro_torch.serve import DSEService, SearchQuery

TASK = tc.analyze(tc.alexnet_cifar(batch_size=4))
CFG = tc.MapperConfig(max_mappings=400, seed=0, enable_bypass=False)
SPACE = dict(num_pes=(64, 256), rf_words=(128,),
             gbuf_words=(16 * 1024, 64 * 1024), bits=16)
WAIT = 600.0


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _query(**kw):
    return SearchQuery(task=TASK, space=ts.ArchSpace.spatial(**SPACE),
                       cfg=CFG, round_size=2, **kw)


def _key(r):
    return (r.best_coords, r.goal_value(),
            [(row["step"], row["coords"], row["value"], row["objectives"],
              row["feasible"]) for row in r.history],
            sorted(r.pareto.values()), r.hypervolume_curve(),
            [w.mapping.factors for w in r.best.per_workload])


def _alone(dev, query):
    kernel.reset_launches()
    with DSEService(workers=1, device=dev) as svc:
        report = svc.submit(query).result(timeout=WAIT)
    return report, dict(kernel.LAUNCHES)


@pytest.mark.gpu
def test_service_engines_agree(card):
    got, launches = _alone(card, _query(backend="cuda"))
    want, ref_launches = _alone(card, _query(backend="torch"))
    assert launches["multi"] > 0
    assert ref_launches == {"single": 0, "multi": 0}
    assert _key(got) == _key(want)
    assert got.manifest.device_name == torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_concurrent_jobs_equal_alone_and_launches_exact(card):
    fused = _query(backend="cuda")
    per_arch = _query(backend="cuda", strategy="anneal", budget=3, seed=1,
                      batching="per-arch")
    alone = [_alone(card, q) for q in (fused, per_arch)]
    kernel.reset_launches()
    with DSEService(workers=2, device=card) as svc:
        tickets = [svc.submit(q) for q in (fused, per_arch)]
        both = [t.result(timeout=WAIT) for t in tickets]
        assert svc.snapshot()["admitted"] == 2
    for (rep, _), got in zip(alone, both):
        assert _key(got) == _key(rep)
    assert dict(kernel.LAUNCHES) == {
        k: alone[0][1][k] + alone[1][1][k] for k in kernel.LAUNCHES}
    assert alone[0][1]["multi"] > 0 and alone[1][1]["single"] > 0


def _big_jobs(enable_bypass):
    wls = [tc.Workload(dims=(4, 16, 8, 3, 3, 8, 8), input_zero_frac=0.2),
           tc.Workload(dims=(2, 32, 16, 1, 1, 4, 4), name="mm")]
    cfg = tc.MapperConfig(max_mappings=3000, seed=0,
                          enable_bypass=enable_bypass)
    hws = [tc.make_spatial_arch(num_pes=16, rf_words=64, gbuf_words=4096,
                                bits=16, zero_skip=True),
           tc.make_spatial_arch(num_pes=64, rf_words=128, gbuf_words=16384,
                                bits=16, zero_skip=False)]
    return [ts.MapspaceJob(tag=(i, wl.name), hw=hw, workload=wl,
                           packed=tc.build_packed_mapspace(wl, hw, cfg))
            for i, hw in enumerate(hws) for wl in wls]


@pytest.mark.gpu
@pytest.mark.parametrize("engine, enable_bypass",
                         [("torch", True), ("cuda", False)])
def test_forced_two_shard_plan_is_bit_equal(card, monkeypatch, engine,
                                            enable_bypass):
    jobs = _big_jobs(enable_bypass)
    key = lambda bs: [(b.tag, b.index, b.value, b.n_scored) for b in bs]
    kernel.reset_launches()
    base = ts.fused_best(jobs, "edp", device=card, backend=engine)
    one = dict(kernel.LAUNCHES)
    monkeypatch.setattr(bf, "_local_devices", lambda dev: (card, card))
    kernel.reset_launches()
    sharded = ts.fused_best(jobs, "edp", device=card, backend=engine)
    launched = ts.fused_collect(ts.fused_launch(jobs, "edp", device=card,
                                                backend=engine))
    assert key(sharded) == key(base) == key(launched)
    if engine == "cuda":
        assert one["multi"] == 1 and kernel.LAUNCHES["multi"] == 4
    else:
        assert kernel.LAUNCHES == {"single": 0, "multi": 0}
