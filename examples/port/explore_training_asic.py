"""Paper case-study II on the PyTorch/CUDA port, the counterpart of
`examples/explore_training_asic.py`: explore training-ASIC designs (PEs x
RF x Gbuf) for AlexNet-CIFAR with the lowest-EDP goal, then show the
effect of zero-skipping (case study I) on the winner.  Scoring runs on
the card unless `--device cpu` is given:

    python examples/port/explore_training_asic.py
    python examples/port/explore_training_asic.py --device cpu
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import (MapperConfig, alexnet_cifar, analyze,
                              evaluate_architecture, explore,
                              generate_arch_space)
from repro_torch.device import as_device

ARCH_SPACE = dict(num_pes=(256, 512), rf_words=(128, 256),
                  gbuf_words=(64 * 1024, 256 * 1024), bits=32,
                  zero_skip=True)


def run(batch_size: int = 64, max_mappings: int = 1200,
        arch_space: dict = ARCH_SPACE, device="cuda") -> dict:
    """Explore, then score the winner with and without zero-skipping ->
    {"explore": the `ExplorationResult`, "on" / "off": the winner's
    `ArchResult` (goal energy) with and without zero-skipping, "gain":
    the energy-per-MAC ratio printed}."""
    dev = as_device(device)
    task = alexnet_cifar(batch_size=batch_size)
    space = list(generate_arch_space(**arch_space))
    cfg = MapperConfig(max_mappings=max_mappings, seed=0)
    res = explore(task, space, goal="edp", cfg=cfg, verbose=True,
                  device=dev)
    best = res.best.hardware
    print(f"\nlowest-EDP design: {best.name} "
          f"(EDP {res.best.network.edp:.3e}, "
          f"area {res.best.network.area_mm2:.1f} mm^2)")

    # zero-skipping ablation on the winning design (case study I)
    tw = analyze(task)
    on = evaluate_architecture(tw, best, cfg, goal="energy", device=dev)
    off_hw = dataclasses.replace(best, zero_skip_level=None)
    off = evaluate_architecture(tw, off_hw, cfg, goal="energy", device=dev)
    gain = off.network.energy_per_mac_pj / on.network.energy_per_mac_pj
    print(f"zero-skipping energy gain on winner: {gain:.2f}x "
          f"({off.network.energy_per_mac_pj:.2f} -> "
          f"{on.network.energy_per_mac_pj:.2f} pJ/MAC)")
    assert gain > 1.0
    return {"explore": res, "on": on, "off": off, "gain": gain}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
