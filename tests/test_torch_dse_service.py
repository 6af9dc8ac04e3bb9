"""The port's DSE search service (`repro_torch.serve.dse_service`) on the
CPU: the counterparts of tests/test_dse_service.py and
tests/test_query_digest.py, and parity with the JAX package's service.

  * coalescing: K concurrent identical queries run exactly one
    `run_search`, every subscriber's stream is equal, and the winners
    equal a fresh solo run's; distinct digests never coalesce; retired
    jobs do not coalesce;
  * cancellation and deadlines give a partial but consistent frontier;
  * the warm cache tier, lifecycle, failures and late replay;
  * `SearchQuery.digest()`: invariant under representation noise and
    `overlap`, sensitive to every semantic field, mixes canonicalized;
  * parity: a real small query through the port's service on both engines
    ("cuda" computes the kernel's plain version on CPU tensors) gives the
    same best, history, frontier and hypervolume curve as
    `repro.serve.dse_service.DSEService` with `backend="jnp"`, and
    `SearchQuery.signature()` equals the JAX package's in every field but
    `backend`.

Every service here runs with `device="cpu"`; threaded tests bound each
wait with a timeout so a logic bug fails instead of hanging.
"""
import dataclasses
import json
import random
import threading
import types

import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro.search as rs
import repro_torch.core as tc
import repro_torch.search as ts
from repro.serve import dse_service as r_svc
from repro_torch.serve import dse_service as svc_mod
from repro_torch.serve import DSEService, SearchQuery

WAIT = 120.0                 # generous outer bound on any real search
CONS = ["area_mm2<=1e4", "power_w<=1e3", "energy_pj<=1e12"]


def _task(m):
    return m.TaskDescription(
        name="tiny", input_shape=(8, 8, 3), batch_size=2,
        processing_type="Inference",
        layers=(m.Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
                m.Pool2D((2, 2), (2, 2), name="p1"),
                m.FC(10, name="fc")))


def _space(m):
    return m.ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                               gbuf_words=(2048, 8192), bits=16)


TASK = _task(tc)
SPACE = _space(ts)
CFG = tc.MapperConfig(max_mappings=200, seed=0)
MEM_A = tc.make_spatial_arch(name="memA", num_pes=16, rf_words=64,
                             gbuf_words=2048, bits=16)
MEM_B = tc.make_spatial_arch(name="memB", num_pes=64, rf_words=64,
                             gbuf_words=8192, bits=16)


def query(**kw) -> SearchQuery:
    kw.setdefault("task", TASK)
    kw.setdefault("space", SPACE)
    kw.setdefault("cfg", CFG)
    return SearchQuery(**kw)


def q(**kw) -> SearchQuery:
    """A query with the default mapper config (the digest tests')."""
    kw.setdefault("task", TASK)
    kw.setdefault("space", SPACE)
    return SearchQuery(**kw)


def service(**kw) -> DSEService:
    return DSEService(device="cpu", **kw)


@pytest.fixture(scope="module")
def solo_report():
    """A fresh, service-free run of the same query: the baseline."""
    return ts.run_search(TASK, SPACE, cfg=CFG, device="cpu")


def _fake_report():
    """Minimal report stand-in for pure-concurrency tests (no scoring)."""
    best = types.SimpleNamespace(hardware=types.SimpleNamespace(name="fk"))
    return types.SimpleNamespace(
        cancelled=False, best=best, goal_value=lambda: 1.0,
        n_evaluated=1, pareto=(), wall_time_s=0.0,
        manifest=types.SimpleNamespace(run_id="run-fake"))


def _gated(gate, calls, result=None):
    """A `run_search` stand-in that waits for `gate`, then returns
    `result(*a, **k)` (default: a fake report)."""
    def spy(*args, **kw):
        calls.append(kw.get("device"))
        assert gate.wait(timeout=WAIT), "gate never released"
        return (result or (lambda *a, **k: _fake_report()))(*args, **kw)
    return spy


# ---------------------------------------------------------------------------
# coalescing, end to end
# ---------------------------------------------------------------------------
def test_concurrent_identical_queries_coalesce(monkeypatch, solo_report):
    K = 5
    gate = threading.Event()
    calls = []
    monkeypatch.setattr(svc_mod, "run_search",
                        _gated(gate, calls, svc_mod.run_search))
    with service(workers=2, tracer=True) as svc:
        barrier = threading.Barrier(K)
        tickets = [None] * K
        errors = []

        def client(i):
            try:
                barrier.wait(timeout=WAIT)
                tickets[i] = svc.submit(query())
            except BaseException as e:   # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors and not any(t.is_alive() for t in threads)
        assert all(t is not None for t in tickets)
        snap = svc.snapshot()
        assert snap["admitted"] == 1
        assert snap["coalesced"] == K - 1
        assert sum(t.coalesced for t in tickets) == K - 1
        digest = tickets[0].digest
        assert all(t.digest == digest for t in tickets)

        gate.set()
        reports = [t.result(timeout=WAIT) for t in tickets]
        # exactly one underlying run_search, on the service's device
        assert calls == [torch.device("cpu")]
        for rep in reports:
            assert rep.best.hardware.name == \
                solo_report.best.hardware.name
            assert rep.goal_value() == solo_report.goal_value()
            assert [row["value"] for row in rep.history] == \
                [row["value"] for row in solo_report.history]
            assert rep.n_evaluated == solo_report.n_evaluated

        streams = [[e.to_dict() for e in t.drain(timeout=5.0)]
                   for t in tickets]
        assert all(s == streams[0] for s in streams[1:])
        kinds = [e["kind"] for e in streams[0]]
        assert kinds[0] == "job-admitted"
        assert kinds[-1] == "job-finished"
        assert kinds.count("job-coalesced") == K - 1
        assert "search-finished" in kinds

        late = svc.subscribe(digest)
        assert late is not None
        assert [e.to_dict() for e in late.drain(timeout=5.0)] == streams[0]

        # per-job provenance manifest, naming the device
        m = reports[0].manifest
        assert m is not None and m.run_id.startswith("run-")
        assert m.device == "cpu"

        # observability: the service's spans, the driver's phases from the
        # worker thread, and the counters
        names = {s.name for s in svc.tracer.buffer.snapshot()}
        assert {"service.admit", "service.coalesce", "service.job",
                "run_search", "propose", "score"} <= names
        metrics = svc.tracer.metrics.snapshot()
        assert metrics["counters"]["service.admitted"] == 1
        assert metrics["counters"]["service.coalesced"] == K - 1

    assert svc.snapshot()["completed"] == 1


@pytest.mark.parametrize("other", [
    dict(constraints="area_mm2<=1e9"),
    dict(space=[tc.make_mix((MEM_A, MEM_A, MEM_B))]),
])
def test_distinct_digests_never_coalesce(monkeypatch, other):
    gate = threading.Event()
    calls = []
    monkeypatch.setattr(svc_mod, "run_search", _gated(gate, calls))
    with service(workers=2) as svc:
        t1 = svc.submit(query())
        t2 = svc.submit(query(**other))
        assert t1.digest != t2.digest
        snap = svc.snapshot()
        assert snap["admitted"] == 2 and snap["coalesced"] == 0
        gate.set()
        t1.result(timeout=WAIT)
        t2.result(timeout=WAIT)
        assert len(calls) == 2


def test_same_mix_queries_coalesce(monkeypatch):
    """Two submits whose mixes differ only in member order (and cosmetic
    name) share one job; a different composition does not."""
    gate = threading.Event()
    calls = []
    monkeypatch.setattr(svc_mod, "run_search", _gated(gate, calls))
    with service(workers=2) as svc:
        t1 = svc.submit(q(space=[tc.make_mix((MEM_A, MEM_B), name="x")]))
        t2 = svc.submit(q(space=[tc.make_mix((MEM_B, MEM_A), name="y")]))
        t3 = svc.submit(q(space=[tc.make_mix((MEM_A, MEM_A, MEM_B))]))
        assert t1.digest == t2.digest
        assert t3.digest != t1.digest
        snap = svc.snapshot()
        assert snap["admitted"] == 2 and snap["coalesced"] == 1
        gate.set()
        for t in (t1, t2, t3):
            t.result(timeout=WAIT)
        assert len(calls) == 2


def test_retired_jobs_do_not_coalesce(monkeypatch):
    monkeypatch.setattr(svc_mod, "run_search",
                        lambda *a, **k: _fake_report())
    with service(workers=1) as svc:
        first = svc.submit(query())
        first.result(timeout=WAIT)
        second = svc.submit(query())     # same digest, job already done
        second.result(timeout=WAIT)
        snap = svc.snapshot()
        assert snap["admitted"] == 2 and snap["coalesced"] == 0
        assert svc.subscribe(first.digest) is not None


# ---------------------------------------------------------------------------
# cancellation and deadlines (partial-frontier results)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["client", "deadline"])
def test_cancel_mid_round_returns_partial_frontier(how):
    """Sequential loop, one architecture a round: a cancel fired (or the
    clock moved past the deadline) by the first round-finished event
    stops the search after round 1 of 4."""
    clk = [0.0]
    qy = query(round_size=1, overlap=False)
    with service(workers=1, clock=lambda: clk[0]) as svc:
        fired = []

        def sink(ev):
            if ev.kind == "round-finished" and not fired:
                fired.append(ev)
                if how == "client":
                    assert svc.cancel(qy.digest())
                else:
                    clk[0] = 1e9             # blow past the deadline

        ticket = svc.submit(qy, sink=sink,
                            timeout_s=10.0 if how == "deadline" else None)
        rep = ticket.result(timeout=WAIT)
        assert rep.cancelled
        assert rep.n_evaluated == 1          # partial: 1 of 4
        assert rep.best is not None
        assert len(rep.pareto) >= 1
        assert [row["coords"] for row in rep.history] == [rep.best_coords]
        assert ticket.status == "cancelled"
        assert ticket.job.cancel_reason == how
        kinds = [e.kind for e in ticket.drain(timeout=5.0)]
        assert "job-cancelled" in kinds
        assert kinds[-1] == "job-finished"
        snap = svc.snapshot()
        assert snap["cancelled"] == 1
        assert snap["expired"] == (how == "deadline")


def test_coalesced_submit_loosens_deadline(monkeypatch):
    gate = threading.Event()
    monkeypatch.setattr(svc_mod, "run_search", _gated(gate, []))
    clk = [0.0]
    with service(workers=1, clock=lambda: clk[0]) as svc:
        t1 = svc.submit(query(), timeout_s=5.0)
        assert t1.job.deadline == 5.0
        svc.submit(query(), timeout_s=60.0)      # most patient wins
        assert t1.job.deadline == 60.0
        svc.submit(query(), timeout_s=None)      # no deadline at all
        assert t1.job.deadline is None
        gate.set()
        t1.result(timeout=WAIT)


# ---------------------------------------------------------------------------
# warm shared cache + lifecycle
# ---------------------------------------------------------------------------
def test_resubmit_after_completion_hits_warm_cache(tmp_path):
    with service(workers=1, cache=str(tmp_path / "cache")) as svc:
        first = svc.submit(query()).result(timeout=WAIT)
        assert first.n_enumerations > 0
        second = svc.submit(query()).result(timeout=WAIT)
        assert second.n_enumerations == 0
        assert second.n_cache_misses == 0
        assert second.best.hardware.name == first.best.hardware.name
        assert second.goal_value() == first.goal_value()
        assert first.manifest_path is not None
        assert second.manifest.run_id != first.manifest.run_id


def test_closed_service_rejects_submits(monkeypatch):
    monkeypatch.setattr(svc_mod, "run_search",
                        lambda *a, **k: _fake_report())
    svc = service(workers=1)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(query())


def test_failed_job_propagates_error(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("scoring exploded")

    monkeypatch.setattr(svc_mod, "run_search", boom)
    with service(workers=1) as svc:
        ticket = svc.submit(query())
        with pytest.raises(RuntimeError, match="scoring exploded"):
            ticket.result(timeout=WAIT)
        assert ticket.status == "failed"
        kinds = [e.kind for e in ticket.drain(timeout=5.0)]
        assert kinds[-1] == "job-finished"
        assert svc.snapshot()["failed"] == 1


def test_unknown_digest_subscribe_returns_none():
    with service(workers=1) as svc:
        assert svc.subscribe("no-such-digest") is None


def test_service_resolves_its_device_once():
    with service(workers=1) as svc:
        assert svc.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DSEService(workers=1)


# ---------------------------------------------------------------------------
# the digest: invariance under representation noise
# ---------------------------------------------------------------------------
def test_digest_is_deterministic():
    assert q().digest() == q().digest()


def test_constraint_order_and_whitespace_irrelevant():
    base = q(constraints=CONS).digest()
    rng = random.Random(0)
    for _ in range(10):
        perm = CONS[:]
        rng.shuffle(perm)
        noisy = [c.replace("<=", " <= ") if rng.random() < 0.5 else c
                 for c in perm]
        assert q(constraints=noisy).digest() == base


@pytest.mark.parametrize("a, b", [
    (dict(strategy="random", strategy_params={"a": 1, "b": 2}),
     dict(strategy="random", strategy_params={"b": 2, "a": 1})),
    (dict(task=TASK), dict(task=tc.analyze(TASK))),
    (dict(space=[SPACE.at(c) for c in SPACE.all_coords()]),
     dict(space=ts.ArchSpace.from_archs(
         [SPACE.at(c) for c in SPACE.all_coords()]))),
    (dict(budget=None), dict(budget=SPACE.size)),
    (dict(budget=None), dict(budget=SPACE.size + 999)),
    (dict(overlap="auto"), dict(overlap=True)),
    (dict(overlap="auto"), dict(overlap=False)),
    (dict(cfg=None), dict(cfg=tc.MapperConfig())),
    (dict(backend="auto"), dict(backend="cuda")),
    (dict(space=[tc.make_mix((MEM_A, MEM_B))]),
     dict(space=[tc.make_mix((MEM_B, MEM_A))])),
    (dict(space=[tc.make_mix((MEM_A, MEM_B), name="x")]),
     dict(space=[tc.make_mix((MEM_A, MEM_B), name="y")])),
], ids=["strategy-params-order", "task-vs-workloads", "list-vs-from-archs",
        "budget-size", "budget-clamp", "overlap-true", "overlap-false",
        "default-cfg", "auto-is-cuda", "mix-member-order", "mix-name"])
def test_representation_noise_keeps_the_digest(a, b):
    assert q(**a).digest() == q(**b).digest()


# ---------------------------------------------------------------------------
# the digest: sensitivity to every semantic field
# ---------------------------------------------------------------------------
def test_every_semantic_field_moves_the_digest():
    base = q().digest()
    variants = {
        "workload": q(task=dataclasses.replace(TASK, batch_size=4)),
        "hw-lattice": q(space=ts.ArchSpace.spatial(
            num_pes=(16, 64), rf_words=(64,), gbuf_words=(2048, 4096),
            bits=16)),
        "constraints": q(constraints="area_mm2<=1e4"),
        "constraint-bound": q(constraints="area_mm2<=2e4"),
        "strategy": q(strategy="random"),
        "strategy-params": q(strategy="random",
                             strategy_params={"x": 1}),
        "budget": q(budget=1),
        "backend": q(backend="torch"),
        "goal": q(goal="latency"),
        "seed": q(seed=1),
        "cfg": q(cfg=tc.MapperConfig(max_mappings=50, seed=0)),
        "objectives": q(objectives=("cycles", "energy_pj")),
        "batching": q(batching="per-arch"),
        "round-size": q(round_size=4),
        "cache-level": q(cache_level="Dram"),
        "use-packed": q(use_packed=False),
    }
    digs = {name: v.digest() for name, v in variants.items()}
    for name, d in digs.items():
        assert d != base, f"changing {name} did not move the digest"
    assert len({base, *digs.values()}) == 1 + len(digs), \
        "distinct queries collided"


def test_lattice_content_not_just_shape():
    a16 = [tc.make_spatial_arch(name=f"a{i}", num_pes=p, rf_words=64,
                                gbuf_words=2048, bits=16)
           for i, p in enumerate((16, 64))]
    a8 = [tc.make_spatial_arch(name=f"a{i}", num_pes=p, rf_words=64,
                               gbuf_words=2048, bits=8)
          for i, p in enumerate((16, 64))]
    assert q(space=a16).digest() != q(space=a8).digest()


def test_constraint_policy_is_semantic():
    pen = ts.ConstraintSet(["area_mm2<=1e4"], policy="penalty")
    die = ts.ConstraintSet(["area_mm2<=1e4"], policy="death")
    assert q(constraints=pen).digest() != q(constraints=die).digest()


def test_schema_version_bump_moves_digest(monkeypatch):
    base = q().digest()
    monkeypatch.setattr(svc_mod, "SERVICE_FORMAT",
                        svc_mod.SERVICE_FORMAT + 1)
    assert q().digest() != base


def test_oversized_space_is_rejected(monkeypatch):
    monkeypatch.setattr(svc_mod, "MAX_DIGEST_ARCHS", 2)
    with pytest.raises(ValueError, match="too large to content-digest"):
        q().digest()


def test_mix_semantics_move_the_digest():
    base = q(space=[tc.make_mix((MEM_A, MEM_B))]).digest()
    variants = {
        "singleton-vs-bare": q(space=[MEM_A]),
        "singleton-mix": q(space=[tc.make_mix((MEM_A,))]),
        "replication": q(space=[tc.make_mix((MEM_A, MEM_A, MEM_B))]),
        "member-content": q(space=[tc.make_mix((
            MEM_A, tc.make_spatial_arch(name="memB", num_pes=64,
                                        rf_words=64, gbuf_words=8192,
                                        bits=8)))]),
        "shared-bw": q(space=[tc.make_mix((MEM_A, MEM_B),
                                          shared_bw_level="DRAM")]),
    }
    digs = {name: v.digest() for name, v in variants.items()}
    for name, d in digs.items():
        assert d != base, f"{name} did not move the digest"
    assert len({base, *digs.values()}) == 1 + len(digs)


def test_mix_space_lattice_digests():
    base = ts.ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                                gbuf_words=(2048,), bits=16)
    one = q(space=ts.MixSpace(base, slots=2, counts=((1, 1),)))
    two = q(space=ts.MixSpace(base, slots=2, counts=((1, 1), (2, 1))))
    bw = q(space=ts.MixSpace(base, slots=2, counts=((1, 1),),
                             shared_bw_level="DRAM"))
    assert len({one.digest(), two.digest(), bw.digest()}) == 3


@pytest.mark.parametrize("kw, exc, match", [
    (dict(strategy=ts.make_strategy("exhaustive", SPACE)), TypeError,
     "registry name"),
    (dict(strategy="definitely-not-registered"), KeyError,
     "unknown strategy"),
    (dict(batching="rows"), ValueError, "batching"),
    (dict(backend="jnp"), ValueError, "backend"),
])
def test_admission_time_validation(kw, exc, match):
    with pytest.raises(exc, match=match):
        q(**kw)


@settings(max_examples=20, deadline=None)
@given(perm=st.permutations(CONS),
       pad=st.lists(st.booleans(), min_size=len(CONS), max_size=len(CONS)))
def test_hypothesis_constraint_permutations(perm, pad):
    noisy = [c.replace("<=", "  <=  ") if p else c
             for c, p in zip(perm, pad)]
    assert q(constraints=noisy).digest() == q(constraints=CONS).digest()


@settings(max_examples=20, deadline=None)
@given(extra=st.integers(min_value=0, max_value=10_000))
def test_hypothesis_budget_clamp(extra):
    assert q(budget=SPACE.size + extra).digest() == q(budget=None).digest()


# ---------------------------------------------------------------------------
# parity with the JAX package's service
# ---------------------------------------------------------------------------
def _query_kw(m, spaces):
    """The same query, as each package builds it."""
    base = spaces.ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                                    gbuf_words=(2048,), bits=16)
    mem_a = m.make_spatial_arch(name="memA", num_pes=16, rf_words=64,
                                gbuf_words=2048, bits=16)
    mem_b = m.make_spatial_arch(name="memB", num_pes=64, rf_words=64,
                                gbuf_words=8192, bits=16)
    return {
        "default": dict(),
        "constrained": dict(constraints=CONS[::-1], strategy="random",
                            strategy_params={"b": 2, "a": 1}, seed=3),
        "workloads": dict(task=m.analyze(_task(m)), budget=99,
                          cfg=m.MapperConfig(max_mappings=50, seed=1)),
        "mix": dict(space=[m.make_mix((mem_b, mem_a), name="x")]),
        "mix-space": dict(space=spaces.MixSpace(base, slots=2,
                                                counts=((1, 1),))),
    }


@pytest.mark.parametrize("name", ["default", "constrained", "workloads",
                                  "mix", "mix-space"])
def test_signature_matches_jax_but_backend(name):
    def sig(m, spaces, svc, backend):
        kw = dict(task=_task(m), space=_space(spaces), backend=backend)
        kw.update(_query_kw(m, spaces)[name])
        return svc.SearchQuery(**kw).signature()
    got = sig(tc, ts, svc_mod, "auto")
    want = sig(rc, rs, r_svc, "jnp")
    assert (got.pop("backend"), want.pop("backend")) == ("cuda", "jnp")
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    assert svc_mod.SERVICE_FORMAT == r_svc.SERVICE_FORMAT


@pytest.fixture(scope="module")
def jax_service_report():
    with r_svc.DSEService(workers=1) as svc:
        return svc.submit(r_svc.SearchQuery(
            task=_task(rc), space=_space(rs), cfg=rc.MapperConfig(
                max_mappings=200, seed=0), strategy="anneal", budget=3,
            round_size=2, seed=1, backend="jnp")).result(timeout=WAIT)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_service_matches_jax_service(jax_service_report, engine):
    with service(workers=2) as svc:
        got = svc.submit(query(strategy="anneal", budget=3, round_size=2,
                               seed=1, backend=engine)).result(timeout=WAIT)
    ref = jax_service_report
    hist = lambda r: [(row["step"], tuple(row["coords"]), row["arch"],
                       row["value"], tuple(row["objectives"] or ()),
                       row["feasible"]) for row in r.history]
    assert got.best_coords == ref.best_coords
    assert got.best.hardware.name == ref.best.hardware.name
    assert got.goal_value() == ref.goal_value()
    assert hist(got) == hist(ref)
    assert sorted(got.pareto.values()) == sorted(ref.pareto.values())
    assert got.hypervolume_curve() == ref.hypervolume_curve()
    assert got.backend == engine
