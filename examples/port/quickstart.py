"""Quickstart on the PyTorch/CUDA port: TRIM end-to-end (paper Fig. 1
pipeline), the counterpart of `examples/quickstart.py`.

Builds the task description for AlexNet-CIFAR training, explores a small
architecture space, prints the optimal design point + its best mapping in
the paper's loop-nest format.  Scoring runs on the card (the mapspace
kernel for the no-bypass rows) unless `--device cpu` is given:

    python examples/port/quickstart.py
    python examples/port/quickstart.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import (MapperConfig, alexnet_cifar, explore,
                              generate_arch_space)
from repro_torch.device import as_device

ARCH_SPACE = dict(num_pes=(64, 256), rf_words=(128, 256),
                  gbuf_words=(32 * 1024, 128 * 1024), bits=32,
                  zero_skip=True)


def run(batch_size: int = 16, max_mappings: int = 1500,
        arch_space: dict = ARCH_SPACE, device="cuda"):
    """Explore and print the winner -> the `ExplorationResult` printed."""
    dev = as_device(device)
    task = alexnet_cifar(batch_size=batch_size)
    archs = list(generate_arch_space(**arch_space))
    cfg = MapperConfig(max_mappings=max_mappings, seed=0,
                       pe_utilization_min=0.5)

    print(f"exploring {len(archs)} architectures "
          f"x {len(cfg.orders)} mapspaces (goal: lowest EDP)\n")
    result = explore(task, archs, goal="edp", cfg=cfg, verbose=True,
                     device=dev)

    best = result.best
    n = best.network
    print(f"\noptimal architecture: {best.hardware.name}")
    print(f"  cycles       : {n.cycles:.4e}")
    print(f"  energy       : {n.energy_pj / 1e6:.3f} uJ")
    print(f"  EDP          : {n.edp:.4e}")
    print(f"  area         : {n.area_mm2:.2f} mm^2")
    print(f"  preprocessing: {n.preproc_cycles:.3e} cycles (inter-layer)")
    print(f"  activations  : {n.onchip_cached_words:.0f} words on-chip, "
          f"{n.dram_cached_words:.0f} spilled to DRAM")

    wr = best.per_workload[0]
    print(f"\nbest mapping for {wr.workload.name} "
          f"(dims N,M,C,R,S,E,F = {wr.workload.dims}):")
    print(wr.mapping.render())
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
