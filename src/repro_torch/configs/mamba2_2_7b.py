"""Config for `mamba2-2.7b` (see registry.py for the full definition
with source citations).  Exposes CONFIG / REDUCED for --arch selection."""
from .registry import get_config, reduced_config

ARCH_ID = "mamba2-2.7b"
CONFIG = get_config(ARCH_ID)
REDUCED = reduced_config(ARCH_ID)
