"""Port's backend dispatch (repro_torch.core.backend) and fused search
scorer (repro_torch.search.batch_frontier) against the JAX package's, on
identical packed mapspaces, on the CPU.

"torch" is compared with "jnp" (the oracles) and "cuda" with "pallas":
on CPU tensors the port's cuda engine scores the eligible rows with the
kernel's plain PyTorch version, the JAX package's pallas engine with its
kernel in interpret mode.  Scores agree to rtol 2e-4, validity and
winners exactly."""
import dataclasses

import numpy as np
import pytest

from repro.core import (MapperConfig, alexnet_cifar, analyze,
                        build_packed_mapspace, make_spatial_arch)
from repro.core import backend as jbackend
from repro.search import MapspaceJob as JaxJob
from repro.search import fused_best as jax_fused_best
from repro.search import per_arch_best as jax_per_arch_best
from repro_torch import convert
from repro_torch.core import backend as tbackend
from repro_torch.obs import Tracer, activate
from repro_torch.search import MapspaceJob, fused_best, per_arch_best

TW = analyze(alexnet_cifar(batch_size=4))
RTOL = 2e-4
ENGINES = [("torch", "jnp"), ("cuda", "pallas")]


def _arch(zero_skip=True, num_pes=64, rf_words=128, gbuf_words=16 * 1024):
    return make_spatial_arch(num_pes=num_pes, rf_words=rf_words,
                             gbuf_words=gbuf_words, bits=16,
                             zero_skip=zero_skip)


def _both(wi, *, bypass, zero_skip=True, n=60, seed=2, hw=None):
    """-> (JAX PackedMapspace slice as arrays, port PackedMapspace)."""
    hw = hw or _arch(zero_skip)
    cfg = MapperConfig(max_mappings=300, seed=seed, enable_bypass=bypass)
    pm = build_packed_mapspace(TW.intra[wi], hw, cfg)
    assert len(pm), "empty mapspace would vacuously pass"
    pm = dataclasses.replace(
        pm, factors=pm.factors[:n], rank=pm.rank[:n], store=pm.store[:n],
        fi=pm.fi[:n], oi=pm.oi[:n], bi=pm.bi[:n])
    port = convert.packed_from_arrays(
        convert.static_from_dict(dataclasses.asdict(pm.static)),
        pm.factors, pm.rank, pm.store, pm.eligible)
    return pm, port


CLASSES = [
    # (id, workload idx, bypass, zero_skip)
    ("conv_sliding_nobypass", 2, False, True),
    ("conv_sliding_bypass_mix", 2, True, True),
    ("wg_nobypass", 28, False, True),
    ("conv_no_zeroskip", 2, False, False),
    ("first_layer_bypass_mix", 0, True, True),
]


@pytest.mark.parametrize("port_engine,jax_engine", ENGINES,
                         ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("name,wi,bypass,zs", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_score_mapspace_matches_jax(name, wi, bypass, zs, port_engine,
                                    jax_engine):
    pm, port = _both(wi, bypass=bypass, zero_skip=zs)
    sj, vj = jbackend.score_mapspace(pm, "edp", backend=jax_engine,
                                     interpret=True)
    st, vt = tbackend.score_mapspace(port, "edp", backend=port_engine,
                                     device="cpu")
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(st, sj, rtol=RTOL)
    assert tbackend.best_index(port, "edp", port_engine, device="cpu") == \
        jbackend.best_index(pm, "edp", jax_engine, interpret=True)
    if bypass:
        assert not port.eligible.all(), "bypass class must split rows"


@pytest.mark.parametrize("goal", ["latency", "energy", "edp"])
def test_every_goal_matches_jax(goal):
    pm, port = _both(2, bypass=True)
    for port_engine, jax_engine in ENGINES:
        sj, _ = jbackend.score_mapspace(pm, goal, backend=jax_engine,
                                        interpret=True)
        st, _ = tbackend.score_mapspace(port, goal, backend=port_engine,
                                        device="cpu")
        np.testing.assert_allclose(st, sj, rtol=RTOL)


def test_validity_mask_matches_jax():
    pm, port = _both(2, bypass=True)
    np.testing.assert_array_equal(
        tbackend.validity_mask_arrays(port.static, port.factors, port.store),
        jbackend.validity_mask_arrays(pm.static, pm.factors, pm.store))


def test_resolve_backend():
    assert tbackend.resolve_backend("auto") == "cuda"
    assert tbackend.resolve_backend("torch") == "torch"
    with pytest.raises(ValueError):
        tbackend.resolve_backend("jnp")


def test_cuda_engine_splits_and_counts_rows():
    _, port = _both(2, bypass=True)
    tr = Tracer()
    with activate(tr):
        tbackend.score_mapspace(port, "edp", "cuda", device="cpu")
    counters = tr.metrics.snapshot()["counters"]
    n_kernel = int(port.eligible.sum())
    assert counters["backend.rows.kernel"] == n_kernel
    assert counters["backend.rows.torch"] == len(port) - n_kernel
    names = {s.name for s in tr.buffer.snapshot()}
    assert {"backend.cuda", "kernel.h2d", "kernel.run", "kernel.d2h",
            "batch_eval.scores"} <= names
    assert not names & {"kernel.pack", "backend.validity"}


def _oversized(wi, n=80):
    """A large architecture's no-bypass rows with a small one's static:
    some rows exceed its fan-out or buffers.  -> (JAX PackedMapspace,
    port PackedMapspace)."""
    small, _ = _both(wi, bypass=False)
    big, _ = _both(wi, bypass=False, n=n, hw=_arch(
        num_pes=256, rf_words=256, gbuf_words=64 * 1024))
    pm = dataclasses.replace(big, static=small.static)
    port = convert.packed_from_arrays(
        convert.static_from_dict(dataclasses.asdict(small.static)),
        pm.factors, pm.rank, pm.store, pm.eligible)
    return pm, port


def test_cuda_engine_takes_validity_from_kernel(monkeypatch):
    """The cuda engine's valid set is the kernel's, equal to the JAX
    package's host check, and the port's host check is not called."""
    pm, port = _oversized(2)
    want = jbackend.validity_mask_arrays(pm.static, pm.factors, pm.store)
    assert 0 < want.sum() < len(want), "needs valid and invalid rows"

    def host_check(*a, **k):
        raise AssertionError("the cuda engine called the host check")
    monkeypatch.setattr(tbackend, "validity_mask_arrays", host_check)
    st, vt = tbackend.score_mapspace(port, "edp", "cuda", device="cpu")
    np.testing.assert_array_equal(vt, want)
    sj, vj = jbackend.score_mapspace(pm, "edp", backend="pallas",
                                     interpret=True)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(st, sj, rtol=RTOL)
    from repro_torch.search import batch_frontier
    assert not hasattr(batch_frontier, "validity_mask_arrays")
    jobs = [MapspaceJob(tag=0, hw=None, workload=None, packed=port)]
    best = fused_best(jobs, "edp", device="cpu", backend="cuda")[0]
    ref = jax_fused_best([JaxJob(tag=0, hw=None, workload=TW.intra[2],
                                 packed=pm)], "edp", backend="pallas")[0]
    assert (best.index, want[best.index]) == (ref.index, True)


def _jobs(bypass):
    """Two architectures x two workloads, both packages' jobs."""
    archs = [_arch(), _arch(num_pes=256, rf_words=256,
                            gbuf_words=64 * 1024)]
    jax_jobs, port_jobs = [], []
    for a, hw in enumerate(archs):
        for wi in (2, 4):
            pm, port = _both(wi, bypass=bypass, hw=hw, n=80, seed=a + 1)
            jax_jobs.append(JaxJob(tag=(a, wi), hw=hw,
                                   workload=TW.intra[wi], packed=pm))
            port_jobs.append(MapspaceJob(tag=(a, wi), hw=None,
                                         workload=None, packed=port))
    return jax_jobs, port_jobs


@pytest.mark.parametrize("port_engine,jax_engine", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_fused_best_matches_jax(port_engine, jax_engine):
    jax_jobs, port_jobs = _jobs(bypass=False)
    ref = jax_fused_best(jax_jobs, "edp", backend=jax_engine)
    tr = Tracer()
    with activate(tr):
        out = fused_best(port_jobs, "edp", device="cpu",
                         backend=port_engine)
    assert [b.tag for b in out] == [b.tag for b in ref]
    assert [b.index for b in out] == [b.index for b in ref]
    np.testing.assert_allclose([b.value for b in out],
                               [b.value for b in ref], rtol=RTOL)
    group = ("fused.kernel-group" if port_engine == "cuda"
             else "fused.torch-group")
    assert {s.name for s in tr.buffer.snapshot()} >= {group}


def test_fused_best_splits_groups_and_keeps_winners():
    _, port_jobs = _jobs(bypass=True)
    whole = fused_best(port_jobs, "edp", device="cpu", backend="torch")
    split = fused_best(port_jobs, "edp", max_group=100, device="cpu",
                       backend="torch")
    assert [b.index for b in split] == [b.index for b in whole]


@pytest.mark.parametrize("port_engine,jax_engine", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_per_arch_best_matches_jax(port_engine, jax_engine):
    """Both packages' mappers build the mapspaces; winners are
    materialized and re-scored by the scalar evaluator."""
    from repro_torch.core.mapspace_array import build_packed_mapspace as tb
    from repro_torch.core.mapper import MapperConfig as TCfg
    jax_jobs, port_jobs = [], []
    for wi in (2, 12):
        hw, wl = _arch(), TW.intra[wi]
        thw = convert.hardware_from_dict(dataclasses.asdict(hw))
        twl = convert.workload_from_dict(dataclasses.asdict(wl))
        pm = build_packed_mapspace(wl, hw, MapperConfig(max_mappings=200,
                                                        seed=wi))
        jax_jobs.append(JaxJob(tag=wi, hw=hw, workload=wl, packed=pm))
        port_jobs.append(MapspaceJob(tag=wi, hw=thw, workload=twl,
                                     packed=tb(twl, thw, TCfg(
                                         max_mappings=200, seed=wi))))
    ref = jax_per_arch_best(jax_jobs, "edp", backend=jax_engine)
    out = per_arch_best(port_jobs, "edp", device="cpu", backend=port_engine)
    assert [(b.tag, b.index, b.value, b.n_scored) for b in out] == \
        [(b.tag, b.index, b.value, b.n_scored) for b in ref]
