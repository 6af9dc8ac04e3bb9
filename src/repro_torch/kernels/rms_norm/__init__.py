"""The RMS norm over a tensor's last dim: CUDA kernel (`kernel.py`,
`csrc/`), plain PyTorch version (`ref.py`) and the model-facing op
(`ops.py`)."""
