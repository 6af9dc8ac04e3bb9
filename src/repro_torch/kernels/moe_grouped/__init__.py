"""The MoE's grouped expert product: PyTorch's grouped GEMM (`kernel.py`),
plain PyTorch version (`ref.py`) and the model-facing op (`ops.py`)."""
