"""The port's per-architecture config modules (`repro_torch.configs.<arch>`,
ARCH_ID / CONFIG / REDUCED) against the JAX package's, field by field: every
field the JAX `ModelConfig` has is equal, and the port's own fields (those
of the `hybrid_moe` family and the dropless MoE's shared width) hold their
defaults, which change nothing for these ten."""
import dataclasses
import importlib

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro_torch.configs import ARCHS

MODULES = sorted(a.replace("-", "_").replace(".", "_") for a in JAX_ARCHS)


def test_every_arch_has_a_module():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert len(MODULES) == 10


@pytest.mark.parametrize("mod", MODULES)
def test_config_module_equals_reference(mod):
    got = importlib.import_module(f"repro_torch.configs.{mod}")
    want = importlib.import_module(f"repro.configs.{mod}")
    assert got.ARCH_ID == want.ARCH_ID
    assert got.ARCH_ID.replace("-", "_").replace(".", "_") == mod
    port_only = {f.name: f.default for f in dataclasses.fields(got.CONFIG)
                 if f.name not in {g.name for g in
                                   dataclasses.fields(want.CONFIG)}}
    assert set(port_only) == {"d_shared", "layer_types",
                              "embedding_multiplier", "residual_multiplier",
                              "logits_scaling", "attention_multiplier"}
    for name in ("CONFIG", "REDUCED"):
        g = dataclasses.asdict(getattr(got, name))
        w = dataclasses.asdict(getattr(want, name))
        assert {k: g[k] for k in w} == w, name
        assert {k: g[k] for k in port_only} == port_only, name
