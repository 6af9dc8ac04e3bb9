"""The port's copies of the search layer's parts against the JAX package's
originals, on inputs made from a numpy seed: strategy ask/tell sequences,
Pareto dominance and hypervolume, constraint parsing, digest and
violation, lattice enumeration, cache keys, the mix scheduler, the run
manifest, and the trace exports.  Every comparison is exact: the copies
share the originals' arithmetic and their `random` streams."""
import json
import random
import types

import numpy as np
import pytest

import repro.core as rc
import repro.obs as ro
import repro.search as rs
import repro_torch.core as tc
import repro_torch.obs as to
import repro_torch.search as ts

STRATEGIES = sorted(rs.STRATEGIES)
AXES = dict(num_pes=(16, 64, 256), rf_words=(64, 128),
            gbuf_words=(2048, 8192, 32768), bits=16)


def _spaces():
    return rs.ArchSpace.spatial(**AXES), ts.ArchSpace.spatial(**AXES)


def test_port_registers_the_same_strategies():
    assert sorted(ts.STRATEGIES) == STRATEGIES


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_ask_tell_sequences(name, seed):
    """Both strategies see the same feedback (values and objective tuples
    drawn from one numpy generator) and must propose the same
    coordinates, round after round."""
    ref_space, port_space = _spaces()
    ref = rs.make_strategy(name, ref_space, seed=seed)
    port = ts.make_strategy(name, port_space, seed=seed)
    assert port.lookahead == ref.lookahead
    rng = np.random.default_rng(seed)
    for _ in range(8):
        want = int(rng.integers(1, 5))
        asked = ref.ask(want)
        assert port.ask(want) == asked
        assert port.exhausted == ref.exhausted
        if not asked:
            break
        feedback = []
        for c in asked:
            objs = tuple(float(v) for v in rng.uniform(1.0, 100.0, 3))
            feasible = bool(rng.random() < 0.8)
            ref.observe(c, objs, feasible)
            port.observe(c, objs, feasible)
            feedback.append((c, float(rng.uniform(1.0, 1e3))))
        ref.tell(feedback)
        port.tell(feedback)


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_repairs_static_constraints_alike(name):
    ref_space, port_space = _spaces()
    areas = sorted(port_space.at(c).total_area()
                   for c in port_space.all_coords())
    cap = f"area_mm2<={areas[len(areas) // 2]!r}"
    ref = rs.make_strategy(name, ref_space, seed=3)
    port = ts.make_strategy(name, port_space, seed=3)
    getattr(ref, "set_constraints", lambda c: None)(
        rs.ConstraintSet.from_any(cap))
    getattr(port, "set_constraints", lambda c: None)(
        ts.ConstraintSet.from_any(cap))
    for _ in range(4):
        asked = ref.ask(3)
        assert port.ask(3) == asked
        fb = [(c, float(i + 1)) for i, c in enumerate(asked)]
        ref.tell(fb)
        port.tell(fb)


def _points(seed, n=40, k=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(1.0, 10.0, (n, k))
    pts[rng.integers(0, n, 5)] = pts[0]                 # exact duplicates
    return [tuple(float(v) for v in p) for p in pts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_front_and_hypervolume(seed):
    pts = _points(seed)
    for a in pts[:10]:
        for b in pts[:10]:
            assert ts.dominates(a, b) == rs.dominates(a, b)
    assert ts.non_dominated(pts) == rs.non_dominated(pts)
    ref_pt = rs.ref_from_values(pts)
    assert ts.ref_from_values(pts) == ref_pt
    assert ts.hypervolume(pts, ref_pt) == rs.hypervolume(pts, ref_pt)
    assert ts.normalize_values(pts, ref_pt) == \
        rs.normalize_values(pts, ref_pt)
    weights = (0.2, 0.3, 0.5)
    assert [ts.scalarize(p, weights, ref_pt) for p in pts] == \
        [rs.scalarize(p, weights, ref_pt) for p in pts]
    objectives = ("cycles", "energy_pj", "area_mm2")
    ref_front, port_front = (rs.ParetoFront(objectives),
                             ts.ParetoFront(objectives))
    for i, p in enumerate(pts):
        assert port_front.add(f"a{i}", p) == ref_front.add(f"a{i}", p)
    assert port_front.values() == ref_front.values()
    assert port_front.hypervolume() == ref_front.hypervolume()
    assert port_front.ref_point() == ref_front.ref_point()
    assert port_front.summary() == ref_front.summary()
    assert ts.DEFAULT_OBJECTIVES == rs.DEFAULT_OBJECTIVES


def _network(seed):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        cycles=float(rng.uniform(1e5, 1e7)),
        energy_pj=float(rng.uniform(1e8, 1e10)),
        area_mm2=float(rng.uniform(1.0, 20.0)),
        edp=float(rng.uniform(1e13, 1e17)))


CONSTRAINTS = [
    "area_mm2<=5.5",
    ["energy_pj<=3e9", "cycles<=5e6"],
    ["area_mm2 <= 12", "power_w<=0.5", "seconds<=0.01", "edp>=1e14"],
]


@pytest.mark.parametrize("spec", CONSTRAINTS, ids=str)
def test_constraint_parsing_digest_and_violation(spec):
    ref = rs.ConstraintSet.from_any(spec)
    port = ts.ConstraintSet.from_any(spec)
    assert str(port) == str(ref)
    assert port.digest() == ref.digest()
    assert port.signature() == ref.signature()
    _, port_space = _spaces()
    ref_space, _ = _spaces()
    for i, (rc_, pc_) in enumerate(zip(ref_space.all_coords(),
                                       port_space.all_coords())):
        rhw, phw = ref_space.at(rc_), port_space.at(pc_)
        net = _network(i)
        assert port.violation(net, phw) == ref.violation(net, rhw)
        assert port.is_feasible(net, phw) == ref.is_feasible(net, rhw)
        assert port.static_violation(phw) == ref.static_violation(rhw)
        assert port.statically_infeasible(phw) == \
            ref.statically_infeasible(rhw)
        v = port.violation(net, phw)
        assert port.penalized(1e15, v) == ref.penalized(1e15, v)
        assert port.skip_value(v) == ref.skip_value(v)
    assert sorted(ts.METRICS) == sorted(rs.METRICS)


@pytest.mark.parametrize("bad, error", [
    ("area_mm2 < 5", ValueError), ("area_mm2<=x", ValueError),
    ("area_mm2<=-1", ValueError), ("volume<=3", KeyError)])
def test_constraint_rejects_malformed_text(bad, error):
    for m in (rs, ts):
        with pytest.raises(error):
            m.Constraint.parse(bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_lattice_enumeration_and_moves(seed):
    ref_space, port_space = _spaces()
    assert port_space.size == ref_space.size == 18
    assert list(port_space.all_coords()) == list(ref_space.all_coords())
    assert [port_space.at(c).name for c in port_space.all_coords()] == \
        [ref_space.at(c).name for c in ref_space.all_coords()]
    r1, r2 = random.Random(seed), random.Random(seed)
    for _ in range(20):
        c = ref_space.random_coords(r1)
        assert port_space.random_coords(r2) == c
        assert port_space.neighbors(c) == ref_space.neighbors(c)
        assert port_space.mutate(c, r2) == ref_space.mutate(c, r1)
        d = ref_space.random_coords(r1)
        assert port_space.random_coords(r2) == d
        assert port_space.crossover(c, d, r2) == \
            ref_space.crossover(c, d, r1)
    archs = list(tc.generate_arch_space(num_pes=(16, 64), rf_words=(64,),
                                        gbuf_words=(2048,), bits=16))
    wrapped = ts.as_space(archs)
    assert [wrapped.at(c).name for c in wrapped.all_coords()] == \
        [a.name for a in archs]


def _task(m):
    return m.TaskDescription(
        name="tiny", input_shape=(8, 8, 3), batch_size=2,
        processing_type="Inference",
        layers=(m.Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
                m.Pool2D((2, 2), (2, 2), name="p1"),
                m.FC(10, name="fc")))


@pytest.mark.parametrize("scorer", ["per-arch", "fused"])
def test_cache_key_for_the_same_arguments(scorer):
    wl = rc.analyze(_task(rc)).intra[0]
    pwl = tc.analyze(_task(tc)).intra[0]
    hw = rc.make_spatial_arch(num_pes=64, rf_words=64, gbuf_words=2048,
                              bits=16)
    phw = tc.make_spatial_arch(num_pes=64, rf_words=64, gbuf_words=2048,
                               bits=16)
    cfg, pcfg = (rc.MapperConfig(max_mappings=150, seed=0),
                 tc.MapperConfig(max_mappings=150, seed=0))
    cons = "area_mm2<=9"
    mix, pmix = rc.make_mix([hw, hw]), tc.make_mix([phw, phw])
    assert ts.mix_digest(pmix) == rs.mix_digest(mix)
    digest = tc.build_packed_mapspace(pwl, phw, pcfg).digest()
    assert digest == rc.build_packed_mapspace(wl, hw, cfg).digest()
    for backend in ("torch", "cuda"):
        for kw in ({}, {"mapspace": digest},
                   {"constraints": ts.ConstraintSet.from_any(cons)
                    .digest()},
                   {"mix": ts.mix_digest(pmix)}):
            got = ts.cache_key(pwl, phw, pcfg, "edp", scorer=scorer,
                               backend=backend, **kw)
            assert got == rs.cache_key(wl, hw, cfg, "edp", scorer=scorer,
                                       backend=backend, **kw)
            # the port's engine names never alias the JAX package's
            assert got != rs.cache_key(wl, hw, cfg, "edp", scorer=scorer,
                                       backend="jnp", **kw)
    assert ts.cache.CACHE_FORMAT == rs.cache.CACHE_FORMAT


def test_cache_codec_round_trip():
    pwl = tc.analyze(_task(tc)).intra[0]
    phw = tc.make_spatial_arch(num_pes=64, rf_words=64, gbuf_words=2048,
                               bits=16)
    res = tc.find_optimal_mapping(pwl, phw, tc.MapperConfig(max_mappings=80),
                                  backend="torch", device="cpu")
    entry = json.loads(json.dumps(ts.encode_result(res)))
    back = ts.decode_result(entry, pwl, phw)
    assert back.mapping.factors == res.mapping.factors
    assert back.estimate == res.estimate
    assert (back.mapspace_size, back.n_valid) == (res.mapspace_size,
                                                  res.n_valid)


def test_schedule_network_two_member_mix():
    """The same members' per-workload results through both schedulers:
    the same assignment and the same combined network."""
    cfg = dict(max_mappings=150, seed=0)
    members = [dict(num_pes=16, rf_words=64, gbuf_words=2048, bits=16),
               dict(num_pes=64, rf_words=64, gbuf_words=8192, bits=16)]

    def schedule(m, **kw):
        tw = m.analyze(_task(m))
        mix = m.make_mix([m.make_spatial_arch(**a) for a in members],
                         shared_bw_level="DRAM")
        per = [m.evaluate_architecture(tw, hw, m.MapperConfig(**cfg), "edp",
                                       **kw).per_workload
               for hw in mix.members]
        return m.schedule_network(mix, per, tw, goal="edp")
    ref = schedule(rc)
    port = schedule(tc, backend="torch", device="cpu")
    assert port.assignment == ref.assignment
    for f in ("cycles", "energy_pj", "edp", "area_mm2"):
        assert getattr(port.network, f) == getattr(ref.network, f), f
    assert list(port.network.utilization) == list(ref.network.utilization)
    assert tc.SCHEDULER_FORMAT == rc.SCHEDULER_FORMAT


def test_manifest_fields(tmp_path):
    """The same search in both packages -> manifests with the same fields
    and values, but the JAX backend name replaced by the torch device."""
    archs = lambda m: list(m.generate_arch_space(
        num_pes=(16, 64), rf_words=(64,), gbuf_words=(2048,), bits=16))
    kw = dict(strategy="exhaustive", trace=True,
              constraints="area_mm2<=1e9")
    ref = rs.run_search(_task(rc), archs(rc),
                        cfg=rc.MapperConfig(max_mappings=150, seed=0),
                        backend="jnp", cache=str(tmp_path / "ref"), **kw)
    port = ts.run_search(_task(tc), archs(tc),
                         cfg=tc.MapperConfig(max_mappings=150, seed=0),
                         backend="torch", device="cpu",
                         cache=str(tmp_path / "port"), **kw)
    rd, pd = ref.manifest.to_dict(), port.manifest.to_dict()
    assert set(rd) - set(pd) == {"jax_backend"}
    assert set(pd) - set(rd) == {"device", "device_name",
                                 "compute_capability"}
    assert (pd["device"], pd["device_name"], pd["compute_capability"]) == \
        ("cpu", None, None)
    for k in ("strategy", "goal", "budget", "space_size", "space_digest",
              "constraints", "constraints_digest", "best_arch",
              "best_value", "version", "git_sha"):
        assert pd[k] == rd[k], k
    assert pd["backend"] == "torch"
    assert set(pd["phase_times"]) == set(rd["phase_times"])
    for k in ("n_evaluated", "n_enumerations", "n_cache_hits",
              "n_cache_misses", "n_feasible", "cache"):
        assert pd["counters"][k] == rd["counters"][k], k
    back = to.RunManifest.read(port.manifest_path)
    assert back.to_dict() == pd
    assert to.space_digest(ts.as_space(archs(tc))) == \
        ro.space_digest(rs.as_space(archs(rc)))


def test_trace_phases_and_exports(tmp_path):
    assert to.DRIVER_PHASES == ro.DRIVER_PHASES
    assert to.PHASES == ro.PHASES
    assert to.EVENT_KINDS == ro.EVENT_KINDS
    assert to.family_of("backend.cuda") == "backend"
    tr = to.Tracer()
    with tr.span("score", phase=True, rows=4):
        with tr.span("fused.kernel-group", jobs=2):
            pass
    tr.count("search.rows_scored", 4)
    text = tr.buffer.to_jsonl()
    back = to.TraceBuffer.from_jsonl(text)
    assert back.to_jsonl() == text
    assert set(back.span_times()) == {"score", "fused.kernel-group"}
    assert set(back.phase_times()) == {"score"}
    chrome = json.loads(open(tr.export_chrome(
        str(tmp_path / "t.json"))).read())
    names = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    assert names == {"score", "fused.kernel-group"}
    assert tr.export_jsonl(str(tmp_path / "t.jsonl"))
    assert to.as_tracer(False) is to.NULL_TRACER
    assert to.as_tracer(tr) is tr
    fn = to.deferred_sync(lambda: 1)
    assert fn.__deferred_sync__ and fn() == 1
