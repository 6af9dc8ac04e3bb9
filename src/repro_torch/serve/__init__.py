"""Serving: the continuous-batching LM engine (`engine.py`) and the
design-space search service (`dse_service.py`)."""
from .dse_service import DSEService, SearchQuery, SearchTicket, ServiceStats
from .engine import Request, ServeEngine

__all__ = ["DSEService", "Request", "SearchQuery", "SearchTicket",
           "ServeEngine", "ServiceStats"]
