"""Training: AdamW with fp32 master weights (`optimizer.py`), the train
step with microbatching and int8 error feedback (`train_step.py`),
checkpoints (`checkpoint.py`) and resilience policy (`resilience.py`)."""
