"""Config for `phi3-mini-3.8b` (see registry.py for the full definition
with source citations).  Exposes CONFIG / REDUCED for --arch selection."""
from .registry import get_config, reduced_config

ARCH_ID = "phi3-mini-3.8b"
CONFIG = get_config(ARCH_ID)
REDUCED = reduced_config(ARCH_ID)
