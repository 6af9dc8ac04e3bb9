"""Launch entry points (`serve.py`: the LM serving engine)."""
