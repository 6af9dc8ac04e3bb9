"""repro_torch.search — pluggable multi-objective DSE search engine.

Layers on top of repro_torch.core's Algorithm-1 machinery:

  space          ArchSpace lattice over architecture parameters
  mix            MixSpace: heterogeneous accelerator-mix lattices whose
                 points are MixDesc tuples (core.scheduler assigns
                 layers/phases to members)
  strategies     Strategy registry: exhaustive | random | anneal | evolve
                 | bandit | hv-evolve
  pareto         ParetoFront over (cycles, energy, area[, edp]),
                 hypervolume + reference-point normalization
  constraints    declarative hardware budgets (area/power/energy/cycles),
                 feasibility masks, penalty policy
  cache          persistent content-addressed mapspace-result cache
  batch_frontier cross-architecture fused mapspace scoring (`fused_best`,
                 and `fused_launch`/`fused_collect` for streamed rounds;
                 the multi-architecture CUDA kernel for no-bypass jobs)
                 and `per_arch_best` (one scoring call per job)
  driver         run_search orchestration -> SearchReport

`core.explorer.explore` is a thin wrapper over
`run_search(strategy="exhaustive", batching="per-arch")`.
"""
from .batch_frontier import (JobBest, MapspaceJob, PendingFused, fused_best,
                             fused_collect, fused_launch, per_arch_best)
from .cache import (ResultCache, cache_key, decode_result, encode_result,
                    mix_digest)
from .constraints import METRICS, Constraint, ConstraintSet
from .driver import (SearchReport, SkippedArch, auto_round_size,
                     run_search)
from .mix import MixSpace
from .pareto import (DEFAULT_OBJECTIVES, OBJECTIVES, ParetoFront,
                     ParetoPoint, dominates, hypervolume, non_dominated,
                     normalize_values, objective_values, ref_from_values,
                     scalarize)
from .space import ArchSpace, as_space
from .strategies import (STRATEGIES, AnnealStrategy, BanditStrategy,
                         EvolveStrategy, ExhaustiveStrategy,
                         HvEvolveStrategy, RandomStrategy, Strategy,
                         make_strategy, register)

__all__ = [n for n in dir() if not n.startswith("_")]
