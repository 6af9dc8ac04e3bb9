"""Config for `whisper-small` (see registry.py for the full definition
with source citations).  Exposes CONFIG / REDUCED for --arch selection."""
from .registry import get_config, reduced_config

ARCH_ID = "whisper-small"
CONFIG = get_config(ARCH_ID)
REDUCED = reduced_config(ARCH_ID)
