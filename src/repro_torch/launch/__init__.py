"""Launch entry points (`serve.py`: the LM serving engine and the DSE
service; `train.py`: the training driver)."""
