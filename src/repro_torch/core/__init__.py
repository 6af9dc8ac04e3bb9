"""TRIM core: the paper's contribution as a composable library.

Pipeline (paper Fig. 1):
  task description --TaskAnalyst--> workloads
  hardware params  --Designer-----> architecture space
  (workload, hw)   --Mapper-------> mapspace
  mapping          --Evaluator----> time / energy / area
  all of the above --Explorer-----> optimal architecture + mappings
"""
from .workload import (ActivationCache, PreprocWorkload, Workload,
                       conv2d_workload, matmul_workload, DIMS, TENSORS)
from .designer import (HardwareDesc, Level, generate_arch_space,
                       make_fpga_arch, make_spatial_arch)
from .task_analyst import (Conv2D, FC, NETWORKS, Pool2D, TaskDescription,
                           analyze, alexnet_cifar, alexnet_imagenet,
                           resnet18_imagenet, resnet20_cifar, vgg11)
from .mapping import Mapping
from .mapper import MapperConfig, Mapspace, build_mapspace, validate
from .mapspace_array import PackedMapspace, build_packed_mapspace
from .evaluator import (Activity, Estimate, NetworkEstimate,
                        analyze_activity, evaluate_mapping, evaluate_network)
from .backend import (BACKENDS, best_index, eligibility_mask,
                      kernel_eligible, resolve_backend, score_mapspace)
from .explorer import (ArchResult, ExplorationResult, GOALS, WorkloadResult,
                       evaluate_architecture, explore, find_optimal_mapping)
from .scheduler import (SCHEDULER_FORMAT, MixDesc, MixEstimate, MixResult,
                        make_mix, mix_estimate_for_assignment,
                        schedule_network)

__all__ = [n for n in dir() if not n.startswith("_")]
