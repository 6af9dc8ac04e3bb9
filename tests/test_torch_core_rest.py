"""The rest of the port's `core/` and the fused shard plan against the JAX
package on the CPU.

  * `core/lower_lm.lower_block`: every registry architecture x every
    `SHAPES` entry gives the same workloads (every field), `repeat` and
    `total_macs`; and the three lowering checks of
    tests/test_lower_lm_adapter.py, on the port;
  * `core/simulator.simulate_activity`: the same word counts as the JAX
    package's on the hypothesis strategies of tests/test_property_oracle.py
    (and the port keeps the analytical-vs-simulated contract);
  * `batch_eval.batch_scores` / `batch_best_index`, `backend.validity_mask`,
    `mapspace_array.packed_candidates`, and `explorer.find_optimal_mapping`
    / `evaluate_architecture` with `use_batch`, `use_packed` and
    `extra_candidates`: scores within rtol 2e-4, validity, indices and
    winners exactly equal (both engines; "cuda" runs the kernel's plain
    version on CPU tensors);
  * the shard plan: the units of tests/test_pipeline_overlap.py, and
    forced two-shard runs over (cpu, cpu) equal to the unsharded ones for
    the oracle and the kernel groups, in `fused_best` and
    `fused_launch`/`fused_collect`.
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro_torch.core as tc
from repro.configs import SHAPES as R_SHAPES, get_config as r_config
from repro.core import backend as r_backend
from repro.core import batch_eval as r_batch_eval
from repro.core import mapspace_array as r_msa
from repro.core import simulator as r_sim
from repro.core.lower_lm import lower_block as r_lower_block
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import backend as t_backend
from repro_torch.core import batch_eval as t_batch_eval
from repro_torch.core import mapspace_array as t_msa
from repro_torch.core import simulator as t_sim
from repro_torch.core.batch_eval import SHARD_MIN_ROWS, shard_bounds
from repro_torch.core.evaluator import COMPUTE, analyze_activity
from repro_torch.core.lower_lm import lower_block
from repro_torch.obs import Tracer, activate
from repro_torch.search import (MapspaceJob, fused_best, fused_collect,
                                fused_launch)
from repro_torch.search import batch_frontier as bf

RTOL = 2e-4
CPU = torch.device("cpu")
ENGINES = ("torch", "cuda")


# ---------------------------------------------------------------------------
# core/lower_lm
# ---------------------------------------------------------------------------
def _lowered(low):
    return ([dataclasses.asdict(w) for w in low.workloads],
            [dataclasses.asdict(w) for w in low.tail], low.repeat,
            low.total_macs(), len(low.all_workloads()))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lower_block_matches_jax(arch):
    for shape in SHAPES:
        assert _lowered(lower_block(get_config(arch), SHAPES[shape])) == \
            _lowered(r_lower_block(r_config(arch), R_SHAPES[shape])), shape


def test_lowered_flops_track_active_params():
    """2 x total_MACs of the FW lowering ~ 2*N_active*D within the
    attention + capacity-factor envelope, for dense and MoE archs."""
    for arch in ("smollm-135m", "phi3-mini-3.8b", "granite-moe-1b-a400m",
                 "deepseek-v2-lite-16b", "mamba2-2.7b"):
        cfg = get_config(arch)
        low = lower_block(cfg, ShapeSpec("t", 4096, 8, "prefill"))
        ratio = 2 * low.total_macs() / (2 * cfg.active_param_count()
                                        * 4096 * 8)
        assert 0.8 <= ratio <= 3.0, (arch, ratio)


def test_training_triples_matmul_work():
    cfg = get_config("smollm-135m")
    fw = lower_block(cfg, ShapeSpec("p", 1024, 4, "prefill")).total_macs()
    tr = lower_block(cfg, ShapeSpec("t", 1024, 4, "train")).total_macs()
    assert tr == pytest.approx(3 * fw)


def test_decode_lowering_uses_kv_cache_length():
    low = lower_block(get_config("smollm-135m"), SHAPES["decode_32k"])
    scores = [w for w in low.workloads if w.name == "scores"]
    assert scores and scores[0].dims[1] == 32768      # M = kv_len
    q = [w for w in low.workloads if w.name == "q"][0]
    assert q.dims[0] == SHAPES["decode_32k"].global_batch


# ---------------------------------------------------------------------------
# core/simulator (the strategies of tests/test_property_oracle.py)
# ---------------------------------------------------------------------------
HW1 = dict(num_pes=1, rf_words=96, gbuf_words=4096, bits=16)
dim = st.integers(min_value=1, max_value=5)
small = st.integers(min_value=1, max_value=3)


def _same_simulation(seed, exact, **wl):
    """The port's simulator equals the JAX package's on the first 12
    mappings of both packages' (identical) mapspaces, and bounds the
    port's analytical counts as the contract says."""
    ref = rc.build_mapspace(rc.Workload(**wl), rc.make_spatial_arch(**HW1),
                            rc.MapperConfig(max_mappings=150, seed=seed))
    port = tc.build_mapspace(tc.Workload(**wl), tc.make_spatial_arch(**HW1),
                             tc.MapperConfig(max_mappings=150, seed=seed))
    for rm, tm in zip(ref.mappings[:12], port.mappings[:12]):
        assert (tm.factors, tm.orders, tm.bypass) == \
            (rm.factors, rm.orders, rm.bypass)
        sim = t_sim.simulate_activity(tm)
        assert sim == r_sim.simulate_activity(rm)
        for p in analyze_activity(tm).pairs:
            s = sim[(p.tensor, p.child)]
            if exact:
                assert p.parent_read == pytest.approx(s["down_words"])
                assert p.parent_write == pytest.approx(s["up_words"])
            else:
                assert p.parent_read >= s["down_words"] - 1e-6
                assert p.parent_write >= s["up_words"] - 1e-6
    assert len(port.mappings) == len(ref.mappings)


@settings(max_examples=15, deadline=None)
@given(n=dim, m=dim, c=dim, e=dim, f=dim, u=small, v=small,
       seed=st.integers(0, 10))
def test_simulator_matmul_like_matches_jax(n, m, c, e, f, u, v, seed):
    _same_simulation(seed, True, dims=(n, m, c, 1, 1, e, f), stride=(u, v))


@settings(max_examples=15, deadline=None)
@given(n=small, m=small, c=small, r=st.integers(2, 3), s=st.integers(1, 3),
       e=dim, f=dim, u=small, v=small, dr=small, ds=small,
       seed=st.integers(0, 10))
def test_simulator_conv_matches_jax(n, m, c, r, s, e, f, u, v, dr, ds, seed):
    _same_simulation(seed, False, dims=(n, m, c, r, s, e, f), stride=(u, v),
                     dilation=(dr, ds))


@settings(max_examples=8, deadline=None)
@given(c=dim, k=st.integers(1, 3), e=dim, f=dim, seed=st.integers(0, 5))
def test_simulator_pool_matches_jax(c, k, e, f, seed):
    _same_simulation(seed, k == 1, dims=(2, 1, c, k, k, e, f),
                     depthwise=True, kind="pool_max")


def test_simulate_pair_compute_child():
    """The innermost interface (child = COMPUTE) of one mapping, pair by
    pair, in both packages."""
    wl = dict(dims=(2, 4, 3, 3, 3, 4, 4), stride=(1, 1))
    rm = rc.build_mapspace(rc.Workload(**wl), rc.make_spatial_arch(**HW1),
                           rc.MapperConfig(max_mappings=50)).mappings[0]
    tm = tc.build_mapspace(tc.Workload(**wl), tc.make_spatial_arch(**HW1),
                           tc.MapperConfig(max_mappings=50)).mappings[0]
    for tensor in ("input", "weight", "output"):
        assert t_sim.simulate_pair(tm, tensor, COMPUTE) == \
            r_sim.simulate_pair(rm, tensor, COMPUTE)


# ---------------------------------------------------------------------------
# batch_eval / backend / mapspace_array extras
# ---------------------------------------------------------------------------
ARCH = dict(num_pes=64, rf_words=128, gbuf_words=16 * 1024, bits=16,
            zero_skip=True)


def _pair(m, n=300, seed=0):
    """AlexNet-CIFAR's intra[2] on one design: (workload, hw, cfg)."""
    wl = m.analyze(m.alexnet_cifar(batch_size=4)).intra[2]
    return wl, m.make_spatial_arch(**ARCH), m.MapperConfig(max_mappings=n,
                                                           seed=seed)


@pytest.fixture(scope="module")
def spaces():
    """Both packages' object and packed mapspaces of the same pair."""
    out = {}
    for name, m in (("ref", rc), ("port", tc)):
        wl, hw, cfg = _pair(m)
        out[name] = {"objects": m.build_mapspace(wl, hw, cfg).mappings,
                     "packed": m.build_packed_mapspace(wl, hw, cfg)}
    return out


@pytest.mark.parametrize("form", ["objects", "packed"])
@pytest.mark.parametrize("goal", ["edp", "latency", "energy"])
def test_batch_scores_matches_jax(spaces, form, goal):
    got_s, got_v = t_batch_eval.batch_scores(spaces["port"][form], goal,
                                             device="cpu")
    want_s, want_v = r_batch_eval.batch_scores(spaces["ref"][form], goal)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=RTOL)


@pytest.mark.parametrize("form", ["objects", "packed"])
@pytest.mark.parametrize("engine", ENGINES)
def test_batch_best_index_matches_jax(spaces, form, engine):
    assert t_batch_eval.batch_best_index(spaces["port"][form], "edp",
                                         engine, device="cpu") == \
        r_batch_eval.batch_best_index(spaces["ref"][form], "edp")


def test_validity_mask_matches_jax(spaces):
    """The mapspace as built (all valid), and the same mappings on a
    design with 16-word register files and a 1,024-word buffer (many
    rows overflow)."""
    def tiny(m, mappings):
        hw = m.make_spatial_arch(num_pes=64, rf_words=16, gbuf_words=1024,
                                 bits=16, zero_skip=True)
        return [dataclasses.replace(x, hardware=hw) for x in mappings]
    for shrink in (False, True):
        port, ref = spaces["port"]["objects"], spaces["ref"]["objects"]
        if shrink:
            port, ref = tiny(tc, port), tiny(rc, ref)
        got = t_backend.validity_mask(port)
        np.testing.assert_array_equal(got, r_backend.validity_mask(ref))
        assert got.all() != shrink


def test_packed_candidates_matches_jax():
    got = t_msa.packed_candidates(*_pair(tc, n=2000))
    want = r_msa.packed_candidates(*_pair(rc, n=2000))
    for f in dataclasses.fields(got[0]):
        assert repr(getattr(got[0], f.name)) == \
            repr(getattr(want[0], f.name)), f.name
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    valid, keep = got[4], got[5]
    assert valid.any() and (keep <= valid).all()


def _extras(m):
    """A warm start: the first 40 mappings of a larger, differently
    seeded mapspace of the same pair, plus one that fails the mapper's
    resource validator (which must never win)."""
    wl, hw, _ = _pair(m)
    cands = m.build_mapspace(wl, hw, m.MapperConfig(max_mappings=3000,
                                                    seed=7)).mappings[:40]
    inner = hw.memory_level_indices()[-1]      # everything in the RF
    bad = dataclasses.replace(cands[0], factors=tuple(
        (tuple(wl.dims) if i == inner else (1,) * 7)
        for i in range(len(cands[0].factors))))
    assert not m.validate(bad, m.MapperConfig().act_reserve)
    return lambda w: list(cands) + [bad]


def _winner(res):
    return (res.mapping.factors, res.mapping.orders, res.mapping.bypass,
            res.mapspace_size, res.n_valid)


@pytest.mark.parametrize("use_packed, use_batch, n",
                         [(False, True, 300), (False, True, 40),
                          (False, False, 120), (True, True, 300)])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("extras", [False, True])
def test_find_optimal_mapping_matches_jax(use_packed, use_batch, n, engine,
                                          extras):
    ref = rc.find_optimal_mapping(
        *_pair(rc, n), "edp", use_batch, "jnp", use_packed,
        _extras(rc) if extras else None)
    got = tc.find_optimal_mapping(
        *_pair(tc, n), "edp", use_batch, engine, use_packed,
        _extras(tc) if extras else None, device="cpu")
    assert _winner(got) == _winner(ref)
    # winners are re-scored by the same float64 scalar evaluator
    assert dataclasses.asdict(got.estimate) == \
        dataclasses.asdict(ref.estimate)


@pytest.mark.parametrize("use_packed", [False, True])
def test_evaluate_architecture_matches_jax(use_packed):
    def run(m, **kw):
        tw = m.analyze(m.TaskDescription(
            name="tiny", input_shape=(8, 8, 3), batch_size=2,
            processing_type="Training",
            layers=(m.Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
                    m.Pool2D((2, 2), (2, 2), name="p1"),
                    m.FC(10, name="fc"))))
        return m.evaluate_architecture(
            tw, m.make_spatial_arch(**ARCH), m.MapperConfig(max_mappings=150,
                                                            seed=0),
            "edp", use_packed=use_packed, **kw)
    ref = run(rc, backend="jnp")
    got = run(tc, backend="cuda", device="cpu")
    assert [_winner(w) for w in got.per_workload] == \
        [_winner(w) for w in ref.per_workload]
    for f in ("cycles", "energy_pj", "edp"):
        assert getattr(got.network, f) == \
            pytest.approx(getattr(ref.network, f), rel=RTOL)


def test_entry_points_validate_engine_and_device():
    wl, hw, cfg = _pair(tc, 40)
    with pytest.raises(ValueError, match="backend"):
        tc.find_optimal_mapping(wl, hw, cfg, backend="jnp", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.find_optimal_mapping(wl, hw, cfg, use_batch=False)


# ---------------------------------------------------------------------------
# shard plan (tests/test_pipeline_overlap.py's units, on the port)
# ---------------------------------------------------------------------------
def test_shard_bounds_units():
    assert shard_bounds(0, 3) == [(0, 0)]
    assert shard_bounds(100, 4) == [(0, 100)]           # min_rows guard
    assert shard_bounds(2 * SHARD_MIN_ROWS, 2) == \
        [(0, SHARD_MIN_ROWS), (SHARD_MIN_ROWS, 2 * SHARD_MIN_ROWS)]
    assert shard_bounds(10001, 2, min_rows=1) == [(0, 5001), (5001, 10001)]
    b = shard_bounds(100, 7, min_rows=10)
    assert b[0][0] == 0 and b[-1][1] == 100
    assert all(hi == nxt_lo for (_, hi), (nxt_lo, _) in zip(b, b[1:]))
    assert all(hi - lo >= 10 for lo, hi in b)
    assert len(shard_bounds(9000, 4)) == 2
    for n, k in ((0, 3), (100, 4), (10001, 2), (9000, 4)):
        assert shard_bounds(n, k) == r_batch_eval.shard_bounds(n, k)


def test_score_devices():
    assert t_batch_eval.score_devices("cpu") == (CPU,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_batch_eval.score_devices()


def test_shard_plan_single_device_is_unsharded():
    assert bf._shard_plan(10 ** 6, ["d0"]) == [((0, 10 ** 6), None)]
    assert bf._shard_plan(100, ["d0", "d1"]) == [((0, 100), None)]
    assert bf._shard_plan(10 ** 6, bf._local_devices("cpu")) == \
        [((0, 10 ** 6), None)]


def test_shard_plan_multi_device_assignment():
    n = 4 * SHARD_MIN_ROWS
    plan = bf._shard_plan(n, ["d0", "d1"])
    assert [b for b, _ in plan] == [(0, n // 2), (n // 2, n)]
    assert [d for _, d in plan] == ["d0", "d1"]


def test_kernel_shard_plan_units():
    assert bf._kernel_shard_plan([0, 1], [10, 10], ["d0"]) == \
        [([0, 1], None)]
    assert bf._kernel_shard_plan([0, 1], [10, 10], ["d0", "d1"]) == \
        [([0, 1], None)]
    cnt = SHARD_MIN_ROWS
    plan = bf._kernel_shard_plan([0, 1, 2, 3], [cnt] * 4, ["d0", "d1"])
    assert [idxs for idxs, _ in plan] == [[0, 1], [2, 3]]
    assert [d for _, d in plan] == ["d0", "d1"]
    plan = bf._kernel_shard_plan([0, 1, 2], [3 * cnt, cnt, cnt],
                                 ["d0", "d1"])
    assert sorted(i for idxs, _ in plan for i in idxs) == [0, 1, 2]


def _big_jobs(enable_bypass):
    """Two designs x two workloads with > 2 * SHARD_MIN_ROWS rows in all,
    so the real plans split over two devices."""
    wls = [tc.Workload(dims=(4, 16, 8, 3, 3, 8, 8), input_zero_frac=0.2),
           tc.Workload(dims=(2, 32, 16, 1, 1, 4, 4), name="mm")]
    cfg = tc.MapperConfig(max_mappings=3000, seed=0,
                          enable_bypass=enable_bypass)
    hws = [tc.make_spatial_arch(num_pes=16, rf_words=64, gbuf_words=4096,
                                bits=16, zero_skip=True),
           tc.make_spatial_arch(num_pes=64, rf_words=128, gbuf_words=16384,
                                bits=16, zero_skip=False)]
    jobs = [MapspaceJob(tag=(i, wl.name), hw=hw, workload=wl,
                        packed=tc.build_packed_mapspace(wl, hw, cfg))
            for i, hw in enumerate(hws) for wl in wls]
    assert sum(j.n_rows() for j in jobs) >= 2 * SHARD_MIN_ROWS
    return jobs


def _key(bests):
    return [(b.tag, b.index, b.value, b.n_scored) for b in bests]


@pytest.mark.parametrize("engine, enable_bypass",
                         [("torch", True), ("cuda", False)])
def test_forced_two_shard_equality(monkeypatch, engine, enable_bypass):
    """(cpu, cpu) as the host's devices: the real plans split the oracle
    group by rows and the kernel group by jobs; winners equal the
    unsharded run's bit for bit, in both `fused_best` and
    `fused_launch`/`fused_collect`."""
    jobs = _big_jobs(enable_bypass)
    base = fused_best(jobs, "edp", device="cpu", backend=engine)
    calls = []
    real_shard, real_kernel = bf._shard_plan, bf._kernel_shard_plan
    monkeypatch.setattr(bf, "_local_devices", lambda dev: (CPU, CPU))
    monkeypatch.setattr(bf, "_shard_plan", lambda n, devices: calls.append(
        "rows") or real_shard(n, devices))
    monkeypatch.setattr(bf, "_kernel_shard_plan",
                        lambda idxs, counts, devices: calls.append("jobs")
                        or real_kernel(idxs, counts, devices))
    tr = Tracer()
    with activate(tr):
        sharded = fused_best(jobs, "edp", device="cpu", backend=engine)
    assert _key(sharded) == _key(base)
    assert _key(fused_collect(fused_launch(
        jobs, "edp", device="cpu", backend=engine))) == _key(base)
    if engine == "torch":
        assert calls == ["rows", "rows"]
        assert {"fused.shard-dispatch", "fused.shard-merge"} <= \
            set(tr.span_times())
        assert real_shard(sum(j.n_rows() for j in jobs), (CPU, CPU))[1][1] \
            == CPU
    else:
        assert calls == ["jobs", "jobs"]
        assert len(real_kernel(list(range(len(jobs))),
                               [j.n_rows() for j in jobs], (CPU, CPU))) == 2


def test_fused_collect_runs_in_the_launching_thread():
    jobs = _big_jobs(True)[:1]
    pending = fused_launch(jobs, "edp", device="cpu", backend="torch")
    errors = []
    t = threading.Thread(target=lambda: errors.append(
        pytest.raises(RuntimeError, fused_collect, pending)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(errors) == 1
    assert math.isfinite(fused_collect(pending)[0].value)


def test_launch_counts_exact_under_threads():
    """Service workers launch the mapspace kernels from several threads:
    the counts stay exact (16 threads, a short switch interval)."""
    import sys
    from repro_torch.kernels.mapspace_eval import kernel
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernel.reset_launches()
        threads = [threading.Thread(target=lambda v=v: [
            kernel.LAUNCHES.add(v) for _ in range(n_each)])
            for v in ("single", "multi") * (n_threads // 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernel.LAUNCHES == {"single": n_threads // 2 * n_each,
                                   "multi": n_threads // 2 * n_each}
    finally:
        sys.setswitchinterval(old)
        kernel.reset_launches()
