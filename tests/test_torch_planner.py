"""The port's TRIM sharding planner (`repro_torch.core.tpu_adapter`)
against the JAX package's (`repro.core.tpu_adapter`) on the CPU.

Both are float64 Python over copies of the same lowering and evaluator,
so every comparison is exact: the same (data_dim, model_dim) winners and
equal `cycles`/`macs` for every architecture in the registry x every
shape it does not skip, at a 32x16 and a 4x2 pod, and the same
logical-rule overrides for each cell on meshes that reach all three
override branches (M: none, N: pure data parallel, C: reduction
sharding).  The reference takes a mesh object; it reads only
`axis_names` and `devices.shape`, so a namespace with those two stands
in for one."""
import dataclasses
import types

import numpy as np
import pytest

import repro.configs as rcfg
import repro.core.tpu_adapter as ref
import repro_torch.configs as tcfg
import repro_torch.core.tpu_adapter as port
from repro_torch.core.workload import matmul_workload

CELLS = [(arch, shape) for arch, cfg in tcfg.ARCHS.items()
         for shape in tcfg.SHAPES if shape not in cfg.skip_shapes]
PODS = [(32, 16), (4, 2)]
#: axis name -> size; the pods above, plus meshes whose dominant plan
#: takes the N (data axis only) and C (a wide model axis) branches
MESHES = [{"data": 32, "model": 16}, {"data": 4, "model": 2},
          {"pod": 2, "data": 2, "model": 2}, {"data": 8}, {"model": 64}]


def _ref_mesh(axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(tuple(axes.values())))


def _plans(mod, cfgs, arch, shape, data_par, model_par):
    out = mod.plan_cell(cfgs.ARCHS[arch], cfgs.SHAPES[shape],
                        data_par=data_par, model_par=model_par)
    return {k: dataclasses.astuple(v) for k, v in out.items()}


def test_same_registry_and_shapes():
    assert list(tcfg.ARCHS) == list(rcfg.ARCHS)
    assert list(tcfg.SHAPES) == list(rcfg.SHAPES)
    assert len(CELLS) == 32


@pytest.mark.parametrize("data_par,model_par", PODS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}|{s}" for a, s in CELLS])
def test_plan_cell_equals_reference(arch, shape, data_par, model_par):
    got = _plans(port, tcfg, arch, shape, data_par, model_par)
    want = _plans(ref, rcfg, arch, shape, data_par, model_par)
    assert got == want                  # winners, cycles and macs exact
    assert len(got) == 4


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}|{s}" for a, s in CELLS])
def test_overrides_equal_reference(arch, shape):
    for axes in MESHES:
        got = port.trim_sharding_overrides(
            tcfg.ARCHS[arch], tcfg.SHAPES[shape], axes)
        want = ref.trim_sharding_overrides(
            rcfg.ARCHS[arch], rcfg.SHAPES[shape], _ref_mesh(axes))
        assert got == want, axes


def test_overrides_reach_every_branch():
    """Across the cells and meshes above, the dominant plan's model dim
    is N, M and C at least once each, so all three override shapes are
    compared."""
    seen = set()
    for arch, shape in CELLS:
        for axes in MESHES:
            ov = port.trim_sharding_overrides(
                tcfg.ARCHS[arch], tcfg.SHAPES[shape], axes)
            seen.add("N" if "batch" in ov else "C" if "embed" in ov
                     else "M")
    assert seen == {"N", "M", "C"}


def test_pure_data_parallel_override_shape():
    ov = port.trim_sharding_overrides(
        tcfg.ARCHS["smollm-135m"], tcfg.SHAPES["train_4k"],
        {"pod": 2, "data": 4})
    assert ov["batch"] == ("pod", "data")
    assert all(ov[a] is None
               for a in ("ff", "heads", "vocab", "experts", "ssm_inner"))


# ---------------------------------------------------------------------------
# tests/test_lower_lm_adapter.py's planner cases, on the port
# ---------------------------------------------------------------------------
def test_factor_clip_divides():
    assert port._factor_clip(48, 16) == 16
    assert port._factor_clip(40, 16) == 10
    assert port._factor_clip(7, 16) == 7
    assert port._factor_clip(9, 4) == 3
    for bound in range(1, 65):
        for want in (1, 2, 3, 4, 16, 100):
            assert port._factor_clip(bound, want) == \
                ref._factor_clip(bound, want)


def test_planner_prefers_token_sharding_for_tall_matmuls():
    wl = matmul_workload(rows=1 << 20, cols=4096, inner=4096, name="mlp")
    choices = port.plan_workload(wl, data_par=32, model_par=16)
    best = choices[0]
    assert best.data_dim == "N"
    assert best.model_dim in ("M", "C")
    from repro.core.workload import matmul_workload as ref_matmul
    want = ref.plan_workload(
        ref_matmul(rows=1 << 20, cols=4096, inner=4096, name="mlp"),
        data_par=32, model_par=16)
    assert [dataclasses.astuple(c) for c in choices] == \
        [dataclasses.astuple(c) for c in want]


def test_planner_cell_and_overrides():
    cfg = tcfg.get_config("nemotron-4-15b")
    plans = port.plan_cell(cfg, tcfg.SHAPES["train_4k"], data_par=32,
                           model_par=16)
    assert plans
    # the reference's case: a one-device ("data", "model") mesh
    ov = port.trim_sharding_overrides(cfg, tcfg.SHAPES["train_4k"],
                                      {"data": 1, "model": 1})
    assert isinstance(ov, dict)
    assert ov == ref.trim_sharding_overrides(
        rcfg.get_config("nemotron-4-15b"), rcfg.SHAPES["train_4k"],
        _ref_mesh({"data": 1, "model": 1}))


def test_tpu_pod_desc_is_valid_trim_hardware():
    hw = port.make_tpu_pod_desc(256)
    assert hw.compute.num_pes == 256
    assert [lv.kind for lv in hw.levels] == ["memory", "routing", "memory",
                                             "compute"]
    assert hw.tiling_levels[1].fanout == 256
    assert dataclasses.astuple(hw) == \
        dataclasses.astuple(ref.make_tpu_pod_desc(256))


# ---------------------------------------------------------------------------
# benchmarks/bench_trim_planner.py's claims, on the port's plans
# ---------------------------------------------------------------------------
BENCH_ARCHS = ("nemotron-4-15b", "granite-moe-1b-a400m", "mamba2-2.7b",
               "deepseek-v2-lite-16b", "smollm-135m")


def test_bench_trim_planner_claims_hold():
    """DP: token (N) sharding on the data axis for most training matmuls;
    TP: feature/reduction sharding on the model axis.  The reference's
    recorded run (BENCH_results.json) has both at 20/20."""
    train = []
    for arch in BENCH_ARCHS:
        cfg = tcfg.ARCHS[arch]
        if "train_4k" in cfg.skip_shapes:
            continue
        train.append(port.plan_cell(cfg, tcfg.SHAPES["train_4k"],
                                    data_par=32, model_par=16))
    choices = [c for plans in train for c in plans.values()]
    n_data = sum(c.data_dim == "N" for c in choices)
    n_model = sum(c.model_dim in ("M", "C") for c in choices)
    assert (n_data, n_model, len(choices)) == (20, 20, 20)
