"""TRIM mapspace scoring: `csrc/mapspace_eval.cu` (kernel), `kernel.py`
(build, bind, launch, launch counts), `ref.py` (plain PyTorch version),
`ops.py` (job records and entry points)."""
