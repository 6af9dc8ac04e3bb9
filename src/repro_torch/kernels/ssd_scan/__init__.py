"""Mamba2 SSD chunked scan: CUDA kernel (`kernel.py`, `csrc/`), plain
PyTorch versions (`ref.py`) and the model-facing op (`ops.py`)."""
