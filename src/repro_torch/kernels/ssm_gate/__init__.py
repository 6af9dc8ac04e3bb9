"""Mamba2's gate chain: CUDA kernel (`kernel.py`, `csrc/`), plain PyTorch
version (`ref.py`) and the model-facing op (`ops.py`)."""
