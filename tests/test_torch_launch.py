"""The port's launchers (`repro_torch.launch.{roofline,dryrun,report}`)
against the JAX package's, on the CPU.

* `model_flops_estimate` and `make_roofline` (given the reference's TPU
  constants) equal the reference's exactly;
* the collective cost model equals `parse_collectives` on the reference's
  own synthetic HLO case (`tests/test_roofline_parse.py`), and `CostMode`
  records the collectives DTensor issues with their result bytes and
  group sizes;
* `report`'s tables are string-equal to the reference's for the same cell
  dicts (the port's `trace_s` in the reference's `compile_s` column);
* `dryrun` on the fake 512-rank mesh (the counterpart of the reference's
  failing `test_dryrun_entrypoint_smoke`) writes the reference's keys;
  its `argument_bytes` equals the local shard bytes that the reference's
  `spec_to_pspec` gives, exactly; a train cell's per-device FLOPs lie
  within [0.9, 2.0] of `model_flops_estimate / n_devices`.
"""
import json
import math

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import report as jax_report
from repro.launch import roofline as jax_rl
from repro.launch import specs as jax_specs
from repro.launch.steps import model_shapes as jax_model_shapes
from repro.models.model import cache_specs as jax_cache_specs
from repro.parallel.sharding import ShardingRules as JaxRules
from repro.parallel.sharding import spec_to_pspec as jax_spec_to_pspec
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as rl

#: the train cell whose per-device FLOPs are held to the model's
RATIO_CELL = ("phi3-mini-3.8b", "train_4k")
RATIO_WINDOW = (0.9, 2.0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_estimate_equals_reference(arch):
    for spec in SHAPES.values():
        assert rl.model_flops_estimate(get_config(arch), spec) == \
            jax_rl.model_flops_estimate(jax_get_config(arch), spec)


ROOF_CASES = [(1e12, 1e9, 1e8, 6e15, 256), (3e9, 7e11, 0.0, 1e12, 512),
              (5e14, 2e10, 4e11, 1e17, 256)]


@pytest.mark.parametrize("f,b,c,m,n", ROOF_CASES)
def test_make_roofline_equals_reference_with_its_constants(f, b, c, m, n):
    kw = dict(flops_per_device=f, bytes_per_device=b, collective_bytes=c,
              model_flops=m, n_devices=n)
    got = rl.make_roofline(**kw, peak_flops=jax_rl.PEAK_FLOPS,
                           hbm_bw=jax_rl.HBM_BW, link_bw=jax_rl.ICI_BW)
    assert got.as_dict() == jax_rl.make_roofline(**kw).as_dict()


def test_roofline_defaults_are_the_h100s():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)


class _Recorded:
    def __init__(self, collectives):
        self.collectives = collectives


def test_collective_cost_model_equals_parse_collectives():
    hlo = """
ENTRY %main.1 (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ar = f32[16,16]{1,0} all-reduce(%p), replica_groups=[4,8]<=[32], to_apply=%add
  ROOT %ag = bf16[64,16]{1,0} all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""
    want = jax_rl.parse_collectives(hlo, 32)
    got = rl.collective_stats(_Recorded([("all-reduce", 16 * 16 * 4, 8),
                                         ("all-gather", 64 * 16 * 2, 4)]),
                              32)
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.transfer_bytes == pytest.approx(want.transfer_bytes)
    assert got.total_transfer == pytest.approx(want.total_transfer)
    # the other kinds, one each, against the reference's formulas
    for kind, k in (("reduce-scatter", 4), ("all-to-all", 8),
                    ("collective-permute", 2)):
        st = rl.collective_stats(_Recorded([(kind, 1024.0, k)]), 32)
        want = {"reduce-scatter": 1024.0 * (k - 1),
                "all-to-all": 1024.0 * (k - 1) / k,
                "collective-permute": 1024.0}[kind]
        assert st.transfer_bytes[kind] == pytest.approx(want)


def test_cost_mode_counts_local_work_and_collectives():
    """On a fake 4 x 4 mesh: a matmul of a row-sharded DTensor counts the
    local FLOPs (1/4 of the global product along data, all of it along
    model), and a redistribution to replicated records one all-gather
    per sharded mesh dim, of the gathered result's bytes, group 4."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    with dryrun.fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
        a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(32, 8, device="meta"), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        _, mode = rl.count_costs(lambda: a @ b)
        assert mode.flops == 2 * 16 * 32 * 8
        _, mode = rl.count_costs(
            lambda: a.redistribute(mesh, [Replicate(), Replicate()]))
        assert mode.collectives == [("all-gather", 64 * 32 * 4, 4)]


# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory):
    """The dry-run CLI on the multi-pod decode cell; -> (cell dict, out
    dir)."""
    out = tmp_path_factory.mktemp("dryrun")
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--mesh", "multi", "--out", str(out)])
    assert exc.value.code == 0
    with open(out / "smollm-135m__decode_32k__multi.json") as f:
        return json.load(f), out


def test_dryrun_decode_cell_on_512_fake_ranks(decode_cell):
    cell, _ = decode_cell
    assert "error" not in cell, cell.get("traceback")
    assert cell["n_devices"] == 512 and cell["mesh"] == "multi"
    for key in ("arch", "shape", "sharding", "remat", "options", "trace_s",
                "memory", "cost", "collectives", "roofline"):
        assert key in cell, key
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes"):
        assert key in cell["memory"]
    assert cell["memory"]["temp_bytes"] == 0          # inference
    assert set(cell["collectives"]["counts"]) == set(rl.COLLECTIVES)
    assert set(cell["roofline"]) == set(jax_rl.Roofline.__dataclass_fields__)
    assert cell["cost"]["flops_per_device"] > 0


def _local_bytes(shape, pspec, sizes, itemsize):
    n = 1
    for i, d in enumerate(shape):
        e = pspec[i] if i < len(pspec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_dryrun_argument_bytes_equal_reference_local_shards(decode_cell):
    cell, _ = decode_cell
    sizes = {"pod": 2, "data": 16, "model": 16}
    mesh = _FakeMesh(sizes)
    jcfg = jax_get_config("smollm-135m")
    spec = SHAPES["decode_32k"]
    rules = JaxRules(mesh_axes=tuple(sizes), seq_shard=False)
    total = 0
    shapes, specs = jax_model_shapes(jcfg)
    is_spec = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    for sp, sh in zip(jax.tree_util.tree_leaves(specs, is_leaf=is_spec),
                      jax.tree_util.tree_leaves(shapes)):
        total += _local_bytes(sh.shape, jax_spec_to_pspec(
            sp, sh.shape, rules, mesh), sizes, sh.dtype.itemsize)
    cache, tok = jax_specs.decode_specs(jcfg, spec)
    for sp, sh in zip(jax.tree_util.tree_leaves(jax_cache_specs(jcfg),
                                                is_leaf=is_spec),
                      jax.tree_util.tree_leaves(cache)):
        total += _local_bytes(sh.shape, jax_spec_to_pspec(
            sp, sh.shape, rules, mesh), sizes, sh.dtype.itemsize)
    total += _local_bytes(tok.shape, jax_spec_to_pspec(
        ("batch",), tok.shape, rules, mesh), sizes, tok.dtype.itemsize)
    assert cell["memory"]["argument_bytes"] == total


def test_report_tables_equal_reference(decode_cell):
    cell, out = decode_cell
    cells = [cell,
             {"arch": "x", "shape": "long_500k", "mesh": "multi",
              "skipped": "full-attention arch: long_500k requires"},
             {"arch": "y", "shape": "train_4k", "mesh": "multi",
              "error": "RuntimeError: boom"}]
    ref_cells = [dict(c, compile_s=c["trace_s"]) if "trace_s" in c else c
                 for c in cells]
    for mesh in ("single", "multi"):
        assert report.dryrun_table(cells, mesh) == \
            jax_report.dryrun_table(ref_cells, mesh)
        assert report.roofline_table(cells, mesh) == \
            jax_report.roofline_table(ref_cells, mesh)
    assert report.load(str(out)) == [cell]
    md = out / "report.md"
    report.main(["--dir", str(out), "--out", str(md)])
    assert "smollm-135m | decode_32k" in md.read_text()


def test_dryrun_train_cell_flops_near_the_model_estimate():
    """Per-device FLOPs of a train cell on 16 x 16, counted on the local
    shards (one microbatch, remat dots_no_batch), against 6*N*D / 256."""
    arch, shape = RATIO_CELL
    cell = dryrun.run_cell(arch, shape, multi_pod=False, microbatches=1)
    ratio = cell["cost"]["flops_per_device"] / (
        rl.model_flops_estimate(get_config(arch), SHAPES[shape]) / 256)
    assert RATIO_WINDOW[0] <= ratio <= RATIO_WINDOW[1], ratio
    assert cell["memory"]["temp_bytes"] > 0
    assert sum(cell["collectives"]["counts"].values()) > 0
