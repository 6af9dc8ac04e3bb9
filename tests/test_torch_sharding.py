"""The port's sharding rules (`repro_torch.parallel.sharding`) and input
specs (`repro_torch.launch.specs`) against the JAX package's, on the CPU
and without a process group: the resolvers need axis sizes only.

Exact throughout: every `spec_to_pspec` result equals the reference's as
a tuple, for every parameter (the port's `param_specs`, the reference's
`launch.steps.model_shapes` specs; a stacked block's leading "layers" dim
resolves to no axis), every `cache_specs` leaf and every batch leaf of
all 10 configs, on the meshes 16x16, 2x16x16, 4x2, 2x2 and 1x1, with fsdp
on and off, seq_shard on and off, and with the TRIM planner's overrides;
input and decode specs have the reference's shapes and dtypes."""
import functools

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.launch.steps import model_shapes as jax_model_shapes
from repro.models.model import cache_specs as jax_cache_specs
from repro.parallel.sharding import ShardingRules as JaxRules
from repro.parallel.sharding import spec_to_pspec as jax_spec_to_pspec
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.convert import STACKED
from repro_torch.core.tpu_adapter import trim_sharding_overrides
from repro_torch.launch import specs
from repro_torch.launch.steps import model_shapes, zero_extend
from repro_torch.models.model import cache_specs
from repro_torch.parallel.sharding import (P, ShardingRules, batch_pspec,
                                           make_rules, placements,
                                           spec_to_pspec)
from torch.distributed.tensor import Replicate, Shard


class FakeMesh:
    """Shape-only stand-in (spec_to_pspec needs axis sizes, not devices)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
RULES = ShardingRules(mesh_axes=("data", "model"))
RULES3 = ShardingRules(mesh_axes=("pod", "data", "model"))


# --------------------------------------------------------------------------
# the cases of tests/test_sharding_rules.py
# --------------------------------------------------------------------------
def test_param_2d_sharding():
    assert spec_to_pspec(("embed", "ff"), (4096, 16384), RULES, MESH) \
        == P("data", "model")


def test_divisibility_fallback_replicates():
    assert spec_to_pspec(("vocab", None), (49155, 1024), RULES, MESH) == P()


def test_duplicate_axis_dedup():
    spec = spec_to_pspec(("batch", "kv_seq", "kv_heads", None),
                         (128, 32768, 32, 128), RULES, MESH)
    assert spec == P("data", "model")


def test_kv_seq_candidate_order_prefers_data():
    spec = spec_to_pspec(("batch", "kv_seq", "kv_heads", None),
                         (1, 524288, 32, 80), RULES, MESH)
    assert spec == P(None, "data", "model")


def test_multipod_batch_axes():
    spec = spec_to_pspec(("batch", "seq"), (256, 4096), RULES3, MESH3)
    assert spec[0] == ("pod", "data")


def test_seq_megatron_sp_over_model():
    spec = spec_to_pspec(("batch", "seq", "embed"), (256, 4096, 6144),
                         RULES, MESH)
    assert spec == P("data", "model")


def test_rank_mismatch_trailing_alignment():
    spec = spec_to_pspec(("batch", "seq", "ff"), (8192, 512), RULES, MESH)
    assert len(spec) <= 2


def test_overrides_win():
    rules = ShardingRules(mesh_axes=("data", "model"),
                          table={"ff": None, "embed": "model"})
    assert spec_to_pspec(("embed", "ff"), (4096, 16384), rules, MESH) \
        == P("model")


def test_moe_cap_takes_data():
    spec = spec_to_pspec(("experts", "moe_cap", None), (64, 61440, 2048),
                         RULES, MESH)
    assert spec == P("model", "data")


def test_partition_spec_is_the_reference_tuple():
    from jax.sharding import PartitionSpec as JP
    assert tuple(P("data", ("pod", "data"), None)) == \
        tuple(JP("data", ("pod", "data"), None))
    assert batch_pspec(RULES3, MESH3) == P(("pod", "data"))


# --------------------------------------------------------------------------
# every leaf of every config, on five meshes and five rule variants
# --------------------------------------------------------------------------
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}
VARIANTS = {"fsdp": dict(fsdp=True, seq_shard=False),
            "nofsdp": dict(fsdp=False, seq_shard=False),
            "sp": dict(fsdp=True, seq_shard=True),
            "nofsdp_sp": dict(fsdp=False, seq_shard=True),
            "trim": dict(fsdp=True, seq_shard=False)}


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """{port name: (reference logical spec, reference shape)}."""
    shapes, spec_tree = jax_model_shapes(jax_get_config(arch))
    out = {}

    def mark(sh, sp, prefix):
        for key, val in sh.items():
            name = prefix + key + (".*" if key in STACKED else "")
            if isinstance(val, dict):
                mark(val, sp[key], name + ".")
            else:
                out[name] = (tuple(sp[key]), tuple(val.shape))

    mark(shapes, spec_tree, "")
    expanded = {}
    for name, (spec, shape) in out.items():
        if ".*." in name:
            head, rest = name.split(".*.", 1)
            n = shape[0]
            for i in range(n):
                expanded[f"{head}.{i}.{rest}"] = (spec, shape)
        else:
            expanded[name] = (spec, shape)
    return expanded


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    shapes, sp = model_shapes(get_config(arch))
    return {n: (sp[n], tuple(p.shape)) for n, p in shapes.items()}


@functools.lru_cache(maxsize=None)
def _overrides(arch, mesh_key):
    return trim_sharding_overrides(get_config(arch), SHAPES["train_4k"],
                                   MESHES[mesh_key])


def _rules(arch, mesh_key, variant):
    sizes = MESHES[mesh_key]
    kw = VARIANTS[variant]
    table = _overrides(arch, mesh_key) if variant == "trim" else {}
    port = make_rules(sizes, overrides=table, **kw)
    ref = JaxRules(mesh_axes=tuple(sizes), table=dict(table), **kw)
    return port, ref, FakeMesh(sizes)


CASES = [(a, m, v) for a in ARCHS for m in MESHES for v in VARIANTS
         if v != "trim" or m in ("16x16", "4x2")]


@pytest.mark.parametrize("arch,mesh_key,variant", CASES)
def test_spec_to_pspec_equals_reference_on_every_leaf(arch, mesh_key,
                                                      variant):
    port_rules, ref_rules, mesh = _rules(arch, mesh_key, variant)
    sizes = MESHES[mesh_key]
    # parameters: a stacked block's leaf has "layers" in front
    ref, port = _reference_params(arch), _port_params(arch)
    assert set(ref) == set(port)
    for name, (spec, shape) in port.items():
        rspec, rshape = ref[name]
        stacked = len(rshape) == len(shape) + 1
        assert rspec[int(stacked):] == spec, name
        want = tuple(jax_spec_to_pspec(rspec, rshape, ref_rules, mesh))
        got = tuple(spec_to_pspec(spec, shape, port_rules, sizes))
        assert (want[1:] if stacked else want) == got, (name, want, got)
    # caches and batches of every shape of the config
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape_name, sspec in SHAPES.items():
        if sspec.kind == "decode":
            cache, _ = specs.decode_specs(cfg, sspec)
            rcache, _ = jax_specs.decode_specs(jcfg, sspec)
            cs, rcs = cache_specs(cfg), jax_cache_specs(jcfg)
            for path, leaf in _leaves(cache):
                rs, rleaf = _get(rcs, path), _get(rcache, path)
                assert _get(cs, path) == rs
                assert tuple(spec_to_pspec(rs, leaf.shape, port_rules,
                                           sizes)) == tuple(
                    jax_spec_to_pspec(rs, rleaf.shape, ref_rules, mesh)), \
                    (shape_name, path)
        blog = specs.batch_logical_specs(cfg)
        assert blog == jax_specs.batch_logical_specs(jcfg)
        for k, leaf in specs.input_specs(cfg, sspec).items():
            assert tuple(spec_to_pspec(blog[k], leaf.shape, port_rules,
                                       sizes)) == tuple(jax_spec_to_pspec(
                blog[k], tuple(leaf.shape), ref_rules, mesh)), \
                (shape_name, k)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# placements and local shard shapes
# --------------------------------------------------------------------------
PLACEMENT_CASES = [
    (P("data", "model"), MESHES["16x16"], (4096, 16384),
     [Shard(0), Shard(1)], (256, 1024)),
    (P(("pod", "data"), None, "model"), MESHES["2x16x16"], (256, 7, 48),
     [Shard(0), Shard(0), Shard(2)], (8, 7, 3)),
    (P(None, "model"), MESHES["4x2"], (3, 8), [Replicate(), Shard(1)],
     (3, 4)),
    (P(), MESHES["2x2"], (5, 6), [Replicate(), Replicate()], (5, 6)),
    (P("data", "model"), MESHES["1x1"], (5, 6), [Replicate(), Replicate()],
     (5, 6)),
    (P(("pod", "data"), "model"), {"pod": 1, "data": 4, "model": 1},
     (8, 6), [Replicate(), Shard(0), Replicate()], (2, 6)),
]


@pytest.mark.parametrize("pspec,sizes,shape,want,local", PLACEMENT_CASES)
def test_placements_and_local_shapes(pspec, sizes, shape, want, local):
    assert placements(pspec, sizes) == want
    # a DTensor's chunking on these placements gives the local shape
    t = torch.empty(shape, device="meta")
    for i, pl in enumerate(want):
        if isinstance(pl, Shard):
            t = t.tensor_split(list(sizes.values())[i], dim=pl.dim)[0]
    assert tuple(t.shape) == local


def test_placements_reject_axis_order_against_the_mesh():
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), MESHES["2x16x16"])


def test_zero_extend_matches_reference_rule():
    sizes = MESHES["16x16"]
    # expert weight sharded on E only: the next free dim takes data
    assert zero_extend(P("model"), (64, 2048, 1408), sizes) \
        == P("model", "data", None)
    # data already used: unchanged
    assert zero_extend(P("data", "model"), (4096, 16384), sizes) \
        == P("data", "model")
    # nothing divisible: unchanged
    assert zero_extend(P(), (9, 3), sizes) == P(None, None)


# --------------------------------------------------------------------------
# input and decode specs against the reference's eval_shape trees
# --------------------------------------------------------------------------
_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.int32): torch.int32}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_and_decode_specs_equal_reference(arch, shape_name):
    cfg, jcfg, sspec = get_config(arch), jax_get_config(arch), \
        SHAPES[shape_name]
    got, want = specs.input_specs(cfg, sspec), \
        jax_specs.input_specs(jcfg, sspec)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _DT[jnp.dtype(want[k].dtype)], k
        assert got[k].is_meta
    if sspec.kind != "decode":
        return
    cache, tok = specs.decode_specs(cfg, sspec)
    rcache, rtok = jax_specs.decode_specs(jcfg, sspec)
    assert tuple(tok.shape) == tuple(rtok.shape) and tok.dtype == torch.int32
    got_leaves = dict(_leaves(cache))
    want_leaves = dict(_leaves(rcache))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == _DT[jnp.dtype(w.dtype)], path
        assert g.is_meta
