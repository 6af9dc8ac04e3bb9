"""The port's exploration path (repro_torch.core.explore, paper Algorithm 1)
against the JAX package's `repro.explore`, end to end on the CPU:
AlexNet-CIFAR training at batch 4 over two architectures, 300-mapping
mapspaces.  Both packages run their own seeded mapper, so this also holds
that the two build the same mapspaces.

Expected: the same best architecture, the same per-workload mappings
(factors, loop orders, bypass), and network cycles/energy within rtol 2e-4
(winners are re-scored by the same float64 scalar evaluator, so in
practice they are equal)."""
import numpy as np
import pytest

from repro.core import MapperConfig, alexnet_cifar, explore, make_spatial_arch
import repro_torch.core as tc

RTOL = 2e-4
ARCHS = [dict(name="pe64_rf128", num_pes=64, rf_words=128,
              gbuf_words=16 * 1024, bits=16, zero_skip=True),
         dict(name="pe256_rf256", num_pes=256, rf_words=256,
              gbuf_words=64 * 1024, bits=16, zero_skip=True)]


@pytest.fixture(scope="module")
def jax_result():
    return explore(alexnet_cifar(batch_size=4),
                   [make_spatial_arch(**a) for a in ARCHS], goal="edp",
                   cfg=MapperConfig(max_mappings=300, seed=0))


def _port(backend):
    return tc.explore(tc.alexnet_cifar(batch_size=4),
                      [tc.make_spatial_arch(**a) for a in ARCHS],
                      goal="edp",
                      cfg=tc.MapperConfig(max_mappings=300, seed=0),
                      backend=backend, device="cpu")


def _mapping_key(m):
    return (m.factors, m.orders, m.bypass)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_explore_matches_jax(jax_result, backend):
    out = _port(backend)
    assert out.best.hardware.name == jax_result.best.hardware.name
    assert [a.hardware.name for a in out.all_archs] == \
        [a.hardware.name for a in jax_result.all_archs]
    for ta, ja in zip(out.all_archs, jax_result.all_archs):
        assert len(ta.per_workload) == len(ja.per_workload) == 29
        for tw, jw in zip(ta.per_workload, ja.per_workload):
            assert tw.workload.name == jw.workload.name
            assert _mapping_key(tw.mapping) == _mapping_key(jw.mapping), \
                (ta.hardware.name, tw.workload.name)
            assert (tw.mapspace_size, tw.n_valid) == \
                (jw.mapspace_size, jw.n_valid)
        np.testing.assert_allclose(
            [ta.network.cycles, ta.network.energy_pj, ta.network.edp],
            [ja.network.cycles, ja.network.energy_pj, ja.network.edp],
            rtol=RTOL)


def test_explore_ties_keep_the_first_architecture():
    """Two identically parameterized designs tie exactly: the earlier one
    wins, as in the JAX package's exhaustive search."""
    twins = [tc.make_spatial_arch(**{**ARCHS[0], "name": n})
             for n in ("first", "second")]
    out = tc.explore(tc.analyze(tc.alexnet_cifar(batch_size=4)), twins,
                     cfg=tc.MapperConfig(max_mappings=100),
                     backend="torch", device="cpu")
    assert out.all_archs[0].network.edp == out.all_archs[1].network.edp
    assert out.best.hardware.name == "first"
