"""The port's search driver (repro_torch.search.run_search) against the JAX
package's `repro.search.run_search(backend="jnp")` on the CPU.

The tiny task and the 4-architecture lattice of tests/test_search.py,
`MapperConfig(max_mappings=200, seed=0)`.  Every registered strategy x
seeds {0, 1} x batching {fused, per-arch} x port engine {torch, cuda} (the
cuda engine runs the kernel's plain version on a CPU tensor) must give
exactly the reference's best coordinates and goal value, history rows
(step, coords, arch, value, objectives, feasible), frontier values and
hypervolume curve.  Winners are re-scored by the same float64 scalar
evaluator in both packages, so "equal" is exact.

The JAX runs share one result cache per batching (a hit decodes to the
same estimate, so reports are unchanged; it keeps the file fast); every
port run starts from a fresh cache.  Also here: a constrained run, the
1-member-mix parity of tests/test_mix_parity.py, a warm disk cache,
cancellation, streamed against synchronous rounds, `fused_launch` /
`fused_collect` against `fused_best`, and `auto_round_size`.
"""
import pytest

import repro.core as rc
import repro.search as rs
import repro_torch.core as tc
import repro_torch.search as ts

STRATEGIES = sorted(rs.STRATEGIES)
SEEDS = (0, 1)
BATCHINGS = ("fused", "per-arch")
ENGINES = ("torch", "cuda")
BUDGET, ROUND = 3, 2


def _task(m):
    return m.TaskDescription(
        name="tiny", input_shape=(8, 8, 3), batch_size=2,
        processing_type="Inference",
        layers=(m.Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
                m.Pool2D((2, 2), (2, 2), name="p1"),
                m.FC(10, name="fc")))


def _archs(m):
    return list(m.generate_arch_space(num_pes=(16, 64), rf_words=(64,),
                                      gbuf_words=(2048, 8192), bits=16))


def _cfg(m, n=200):
    return m.MapperConfig(max_mappings=n, seed=0)


def _jax(**kw):
    return rs.run_search(_task(rc), _archs(rc), goal="edp", cfg=_cfg(rc),
                         backend="jnp", **kw)


def _port(engine, **kw):
    return ts.run_search(_task(tc), _archs(tc), goal="edp", cfg=_cfg(tc),
                         backend=engine, device="cpu", **kw)


def _history(report):
    return [(row["step"], tuple(row["coords"]), row["arch"], row["value"],
             tuple(row["objectives"] or ()), row["feasible"])
            for row in report.history]


def _winners(arch_result):
    return [(w.workload.name, w.mapping.factors, w.mapping.orders,
             w.mapping.bypass) for w in arch_result.per_workload]


def assert_same_report(port, ref):
    assert port.best_coords == ref.best_coords
    assert port.best.hardware.name == ref.best.hardware.name
    assert port.goal_value() == ref.goal_value()
    assert _winners(port.best) == _winners(ref.best)
    assert _history(port) == _history(ref)
    assert sorted(port.pareto.values()) == sorted(ref.pareto.values())
    assert port.hypervolume_curve() == ref.hypervolume_curve()
    assert port.n_evaluated == ref.n_evaluated


@pytest.fixture(scope="module")
def jax_runs():
    """(strategy, seed, batching) -> the JAX package's report."""
    caches = {b: rs.ResultCache() for b in BATCHINGS}
    memo = {}

    def get(strategy, seed, batching):
        key = (strategy, seed, batching)
        if key not in memo:
            memo[key] = _jax(strategy=strategy, seed=seed, budget=BUDGET,
                             round_size=ROUND, batching=batching,
                             cache=caches[batching])
        return memo[key]
    return get


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batching", BATCHINGS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_search_matches_jax(jax_runs, strategy, seed, batching, engine):
    ref = jax_runs(strategy, seed, batching)
    port = _port(engine, strategy=strategy, seed=seed, budget=BUDGET,
                 round_size=ROUND, batching=batching)
    assert port.strategy == ref.strategy == strategy
    assert port.backend == engine
    assert port.overlap == ref.overlap
    assert_same_report(port, ref)
    # the port's per-arch path builds packed mapspaces too (one per
    # (arch, distinct workload) scored; the JAX per-arch path builds none);
    # each port run starts from a fresh cache, so every scored mapspace
    # was a miss
    assert port.n_packed_builds == port.n_enumerations \
        == port.n_cache_misses > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_constrained_run_matches_jax(engine):
    """A static area cap that rejects the two 64-PE designs before any
    mapspace is built, and a dynamic energy bound."""
    areas = sorted(hw.total_area() for hw in _archs(tc))
    cons = [f"area_mm2<={(areas[1] + areas[2]) / 2!r}", "energy_pj<=1e12"]
    ref = _jax(strategy="exhaustive", constraints=cons, round_size=ROUND)
    port = _port(engine, strategy="exhaustive", constraints=cons,
                 round_size=ROUND)
    assert_same_report(port, ref)
    assert port.n_skipped_infeasible == ref.n_skipped_infeasible == 2
    assert [r.get("skipped", False) for r in port.history] == \
        [r.get("skipped", False) for r in ref.history]
    assert str(port.constraints) == str(ref.constraints)
    assert port.constraints.digest() == ref.constraints.digest()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_member_mix_parity(strategy, seed):
    """A 1-member MixSpace search is bit-identical to the plain search
    (tests/test_mix_parity.py's contract, on the port)."""
    base = ts.ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                                gbuf_words=(2048, 8192), bits=16)
    kw = dict(goal="edp", strategy=strategy, cfg=_cfg(tc, 150), seed=seed,
              budget=4, round_size=2, device="cpu")
    single = ts.run_search(_task(tc), base, **kw)
    mixed = ts.run_search(_task(tc), ts.MixSpace(base), **kw)
    strip = lambda h: [r[:2] + r[3:] for r in h]     # arch name differs
    assert strip(_history(single)) == strip(_history(mixed))
    assert single.best_coords == mixed.best_coords
    assert single.goal_value() == mixed.goal_value()
    assert single.hypervolume_curve() == mixed.hypervolume_curve()
    ns, nm = single.best.network, mixed.best.network
    for f in ("cycles", "dynamic_pj", "static_pj", "cache_static_pj",
              "energy_pj", "edp", "area_mm2", "preproc_cycles"):
        assert getattr(ns, f) == getattr(nm, f), f
    assert mixed.best.hardware.name == f"mix[{single.best.hardware.name}]"
    for rs_, rm in zip(single.best.per_workload, mixed.best.per_workload):
        assert rs_.mapping.factors == rm.mapping.factors


def test_two_member_mix_matches_jax():
    """A 2-slot mix (one member each of two designs) through the port's
    scheduler equals the JAX package's."""
    def run(m, search, **kw):
        base = search.ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                                        gbuf_words=(2048, 8192), bits=16)
        space = search.MixSpace(base, slots=2, counts=((1, 1),),
                                shared_bw_level="DRAM")
        return search.run_search(_task(m), space, goal="edp",
                                 strategy="exhaustive", cfg=_cfg(m, 150),
                                 budget=3, round_size=2, **kw)
    ref = run(rc, rs, backend="jnp")
    port = run(tc, ts, backend="torch", device="cpu")
    assert_same_report(port, ref)
    extra = lambda r: [(row["members"], row["assignment"],
                        row["utilization"]) for row in r.history]
    assert extra(port) == extra(ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_warm_disk_cache_is_all_hits(tmp_path, engine):
    kw = dict(strategy="anneal", budget=3, round_size=ROUND, seed=1,
              cache=str(tmp_path))
    cold = _port(engine, **kw)
    warm = _port(engine, **kw)           # a fresh ResultCache on the dir
    assert cold.n_cache_hits == 0 and cold.n_cache_misses > 0
    assert warm.n_cache_misses == 0
    assert warm.n_cache_hits == cold.n_cache_misses
    assert warm.cache_stats["hits_disk"] == cold.n_cache_misses
    assert warm.n_enumerations == 0
    assert_same_report(warm, cold)
    assert warm.manifest_path and warm.manifest.device == "cpu"
    assert warm.manifest.device_name is None
    assert warm.manifest.backend == engine


@pytest.mark.parametrize("batching", BATCHINGS)
def test_cancel_after_first_round_matches_jax(batching):
    def after_first():
        calls = []
        return lambda: calls.append(1) or len(calls) > 1
    kw = dict(strategy="exhaustive", round_size=ROUND, batching=batching,
              overlap=False)
    ref = _jax(cancel=after_first(), **kw)
    port = _port("cuda", cancel=after_first(), **kw)
    assert port.cancelled and ref.cancelled
    assert port.n_evaluated == ROUND
    assert_same_report(port, ref)


def test_cancel_before_any_round_raises():
    with pytest.raises(RuntimeError, match="cancelled"):
        _port("torch", cancel=lambda: True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", ["exhaustive", "random"])
def test_streamed_equals_synchronous(strategy, engine):
    kw = dict(strategy=strategy, round_size=ROUND, seed=1, trace=True)
    streamed = _port(engine, overlap=True, **kw)
    sync = _port(engine, overlap=False, **kw)
    assert streamed.overlap and not sync.overlap
    assert_same_report(streamed, sync)
    assert "device-wait" in streamed.phase_times
    assert "device-wait" not in sync.phase_times


@pytest.mark.parametrize("batching", BATCHINGS)
def test_object_pipeline_equals_packed(batching):
    """`use_packed=False` (the object mapspaces of `build_mapspace`) picks
    the same designs and mappings as the packed default; only the packed
    runs build packed mapspaces."""
    kw = dict(strategy="exhaustive", round_size=ROUND, batching=batching)
    packed = _port("cuda", **kw)
    objects = _port("cuda", use_packed=False, **kw)
    assert_same_report(objects, packed)
    assert objects.n_packed_builds == 0
    assert packed.n_packed_builds == packed.n_enumerations > 0


def test_round_size_auto_matches_jax():
    ref = _jax(strategy="exhaustive", round_size="auto")
    port = _port("cuda", strategy="exhaustive", round_size="auto")
    assert_same_report(port, ref)


@pytest.mark.parametrize("mean", [0, 1, 37.5, 500, 1024, 2048, 65536,
                                  10 ** 6])
def test_auto_round_size_matches_jax_at_one_device(mean):
    from repro.search.driver import auto_round_size as ref_auto
    assert ts.auto_round_size(mean) == ref_auto(mean, n_devices=1)
    assert ts.auto_round_size(mean) == ts.auto_round_size(mean, 1)


def test_port_fused_path_scores_on_one_device():
    """On the CPU the shard plan has one device, so every fused group is
    one unpinned entry: scored on the device the caller gave."""
    import torch
    from repro_torch.search import batch_frontier
    devices = batch_frontier._local_devices("cpu")
    assert devices == (torch.device("cpu"),)
    assert batch_frontier._shard_plan(10 ** 6, devices) == \
        [((0, 10 ** 6), None)]
    assert batch_frontier._kernel_shard_plan([0, 1], [10 ** 5] * 2,
                                             devices) == [([0, 1], None)]


def _jobs(enable_bypass):
    cfg = tc.MapperConfig(max_mappings=150, seed=0,
                          enable_bypass=enable_bypass)
    wls = tc.analyze(_task(tc)).intra
    return [ts.MapspaceJob(tag=(hw.name, wl.name), hw=hw, workload=wl,
                           packed=tc.build_packed_mapspace(wl, hw, cfg))
            for hw in _archs(tc) for wl in wls]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("enable_bypass", [False, True])
def test_fused_launch_collect_equals_fused_best(engine, enable_bypass):
    jobs = _jobs(enable_bypass)
    want = ts.fused_best(jobs, "edp", device="cpu", backend=engine)
    pending = ts.fused_launch(jobs, "edp", device="cpu", backend=engine)
    assert isinstance(pending, ts.PendingFused)
    # kernel groups (no-bypass jobs under "cuda") resolve at launch; the
    # oracle groups wait for fused_collect
    resolved = [b is not None for b in pending.out]
    if engine == "torch":
        assert not any(resolved) and pending.groups
    elif not enable_bypass:
        assert all(resolved) and not pending.groups
    got = ts.fused_collect(pending)
    assert [(b.tag, b.index, b.value, b.n_scored) for b in got] == \
        [(b.tag, b.index, b.value, b.n_scored) for b in want]


def test_progress_events_match_jax():
    from repro.obs import CollectSink as RefSink
    from repro_torch.obs import CollectSink
    ref_sink, port_sink = RefSink(), CollectSink()
    _jax(strategy="random", budget=3, round_size=ROUND, seed=0,
         progress=ref_sink)
    _port("torch", strategy="random", budget=3, round_size=ROUND, seed=0,
          progress=port_sink)
    strip = lambda sink: [(e.kind, {k: v for k, v in e.payload.items()
                                    if k != "wall_time_s"})
                          for e in sink.events]
    assert strip(port_sink) == strip(ref_sink)


def test_run_search_rejects_bad_arguments():
    with pytest.raises(ValueError, match="backend"):
        _port("jnp")
    with pytest.raises(ValueError, match="batching"):
        _port("torch", batching="sharded")
    with pytest.raises(ValueError, match="overlap"):
        _port("torch", overlap="sometimes")


def test_explore_is_the_run_search_wrapper(monkeypatch):
    """`explore` calls run_search(strategy="exhaustive",
    batching="per-arch") on the given device and engine."""
    from repro_torch.search import driver
    seen = {}
    real = driver.run_search

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(driver, "run_search", spy)
    out = tc.explore(_task(tc), _archs(tc), cfg=_cfg(tc), backend="torch",
                     device="cpu")
    assert (seen["strategy"], seen["batching"], seen["backend"],
            seen["device"]) == ("exhaustive", "per-arch", "torch", "cpu")
    ref = _port("torch", strategy="exhaustive", batching="per-arch")
    assert [a.hardware.name for a in out.all_archs] == \
        [a.hardware.name for a in ref.all_archs]
    assert out.best.hardware.name == ref.best.hardware.name
