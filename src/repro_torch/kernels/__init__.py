"""Hand-written CUDA kernels (sm_90a), each beside its plain PyTorch
version (`ref.py`) and its host packer (`ops.py`)."""
