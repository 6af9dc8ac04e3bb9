"""The port's per-architecture config modules (`repro_torch.configs.<arch>`,
ARCH_ID / CONFIG / REDUCED) against the JAX package's, field by field."""
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
    for name in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(got, name)) == \
            dataclasses.asdict(getattr(want, name)), name
