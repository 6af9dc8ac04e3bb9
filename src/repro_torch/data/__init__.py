"""The training data pipeline (`pipeline.py`): numpy batches, stateless
by index."""
