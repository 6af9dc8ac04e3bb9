"""repro_torch.search — cross-architecture fused mapspace scoring.

  batch_frontier  `fused_best` (one call per BatchSig group, the
                  multi-architecture CUDA kernel for no-bypass jobs) and
                  `per_arch_best` (one scoring call per job)
"""
from .batch_frontier import JobBest, MapspaceJob, fused_best, per_arch_best

__all__ = [n for n in dir() if not n.startswith("_")]
