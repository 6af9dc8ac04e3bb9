"""Serving: the continuous-batching LM engine (`engine.py`)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
