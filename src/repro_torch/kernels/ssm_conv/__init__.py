"""Mamba2's causal conv chain: CUDA kernel (`kernel.py`, `csrc/`), plain
PyTorch version (`ref.py`) and the model-facing op (`ops.py`)."""
