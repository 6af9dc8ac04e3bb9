"""Config for `smollm-135m` (see registry.py for the full definition
with source citations).  Exposes CONFIG / REDUCED for --arch selection."""
from .registry import get_config, reduced_config

ARCH_ID = "smollm-135m"
CONFIG = get_config(ARCH_ID)
REDUCED = reduced_config(ARCH_ID)
