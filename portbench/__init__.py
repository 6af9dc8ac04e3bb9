"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): its
harness (`run.py`, `harness.py`, `trace.py`), the cells' data files
(`configs/`, `traffic/`, `limits/`), one reader a metric (`metrics/`), the
plain references (`reference/`), the yardstick of work (`roofline/`), the
control of the check (`control.py`) and its CPU tests (`tests/`).  Nothing
here imports the JAX package or JAX."""
