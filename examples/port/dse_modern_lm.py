"""Beyond the paper, on the PyTorch/CUDA port: TRIM design-space
exploration for a *modern* LLM, the counterpart of
`examples/dse_modern_lm.py`.

Lowers deepseek-v2-lite's transformer blocks to TRIM workloads
(core/lower_lm) and finds the optimal mapping of the largest ones on a
1024-PE accelerator — the same Algorithm-1 machinery the paper runs on
AlexNet, pointed at a 2024 MoE architecture.  Also prints the TRIM
sharding planner's (data_dim, model_dim) recommendation per dominant
workload for the production TPU mesh.  Scoring runs on the card unless
`--device cpu` is given:

    python examples/port/dse_modern_lm.py [--device cpu]

With --strategy, runs the repro_torch.search engine over a widened
PEs x RF x Gbuf lattice instead — e.g. simulated annealing at a small
budget:

    python examples/port/dse_modern_lm.py \\
        --strategy anneal --budget 8 --compare-exhaustive

which demonstrates >10x fewer architecture evaluations than exhaustive
for a near-optimal (target <=5% worse EDP) design.  Hardware budgets turn
the run into the paper's constrained design-selection workflow — e.g. the
surrogate-model bandit under an area cap:

    python examples/port/dse_modern_lm.py \\
        --strategy bandit --budget 12 --max-area 400 --max-power 30

Designs violating the area cap are rejected before any mapspace scoring;
the report prints the feasible fraction and the (normalized) frontier
hypervolume alongside the Pareto set.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import (MapperConfig, find_optimal_mapping,
                              make_spatial_arch)
from repro_torch.core.lower_lm import lower_block
from repro_torch.core.task_analyst import TaskWorkloads
from repro_torch.core.tpu_adapter import plan_cell
from repro_torch.device import as_device
from repro_torch.search import STRATEGIES, ArchSpace, ResultCache, run_search

ARCH = "deepseek-v2-lite-16b"
SEARCH_LATTICE = dict(
    num_pes=(256, 512, 1024, 2048, 4096),
    rf_words=(128, 256, 512, 1024),
    gbuf_words=(128 * 1024, 256 * 1024, 512 * 1024, 1024 * 1024))


def lm_task_workloads(top_k=3):
    """Dominant workloads of one deepseek-v2-lite training block as a TRIM
    task (no inter-layer records: block-level DSE only)."""
    cfg = get_config(ARCH)
    spec = ShapeSpec("small_train", 512, 8, "train")
    lowered = lower_block(cfg, spec)
    top = sorted(lowered.workloads, key=lambda w: -w.macs)[:top_k]
    return cfg, TaskWorkloads(intra=top, preproc=[], activations=[])


def run(top_k: int = 5, max_mappings: int = 1500, device="cuda") -> dict:
    """The block report: lowering, the optimal mapping of the `top_k`
    largest workloads on a 1024-PE design, the planner's sharding plan ->
    {"lowered": the `LoweredLM`, "mappings": [(workload, its
    `WorkloadResult`)], "plans": `plan_cell`'s plans}."""
    dev = as_device(device)
    cfg = get_config(ARCH)
    spec = ShapeSpec("small_train", 512, 8, "train")  # CPU-sized instance
    lowered = lower_block(cfg, spec)
    print(f"{cfg.name}: one block lowers to {len(lowered.workloads)} TRIM "
          f"workloads x {lowered.repeat} layers "
          f"({lowered.total_macs() / 1e12:.2f} TMACs total)\n")

    top = sorted(lowered.workloads, key=lambda w: -w.macs)[:top_k]
    hw = make_spatial_arch(num_pes=1024, rf_words=512,
                           gbuf_words=512 * 1024, bits=16, zero_skip=False)
    mcfg = MapperConfig(max_mappings=max_mappings, seed=0,
                        pe_utilization_min=0.5)
    print(f"optimal mappings on {hw.name} (1024 PE accelerator):")
    mappings = []
    for wl in top:
        r = find_optimal_mapping(wl, hw, mcfg, goal="latency", device=dev)
        mappings.append((wl, r))
        print(f"  {wl.name:14s} dims={wl.dims}  "
              f"cycles={r.estimate.cycles:.3e} "
              f"pe_util={r.estimate.pe_utilization:.2f}")

    print("\nTRIM sharding plan for the production pod "
          "(data=32, model=16), train_4k:")
    plans = plan_cell(cfg, SHAPES["train_4k"], data_par=32, model_par=16)
    for w, c in plans.items():
        print(f"  {w:14s} -> shard {c.data_dim} over data, "
              f"{c.model_dim} over model   (est {c.cycles:.3e} cyc)")
    return {"lowered": lowered, "mappings": mappings, "plans": plans}


def run_search_dse(strategy: str, budget: int, compare: bool,
                   seed: int = 0, backend: str = "auto",
                   max_area: float = None, max_power: float = None,
                   trace: str = None, *, max_mappings: int = 1200,
                   device="cuda"):
    """`run_search` over SEARCH_LATTICE, printed -> (its `SearchReport`,
    the exhaustive reference's with `compare`, else None)."""
    dev = as_device(device)
    constraints = []
    if max_area is not None:
        constraints.append(f"area_mm2<={max_area}")
    if max_power is not None:
        constraints.append(f"power_w<={max_power}")
    constraints = constraints or None

    cfg, tw = lm_task_workloads()
    space = ArchSpace.spatial(bits=16, zero_skip=False, **SEARCH_LATTICE)
    mcfg = MapperConfig(max_mappings=max_mappings, seed=0,
                        pe_utilization_min=0.5)
    cache = ResultCache()
    print(f"{cfg.name}: searching a {space.size}-point lattice "
          f"({'x'.join(str(len(v)) for v in space.axis_values)}) with "
          f"strategy={strategy}, budget={budget}, backend={backend}"
          + (f", constraints={' & '.join(constraints)}" if constraints
             else "") + "\n")

    rep = run_search(tw, space, goal="edp", cfg=mcfg, strategy=strategy,
                     budget=budget, cache=cache, seed=seed, verbose=True,
                     backend=backend, constraints=constraints,
                     trace=bool(trace), device=dev)
    if trace:
        rep.tracer.export_chrome(trace)
        total = sum(rep.phase_times.values()) or 1.0
        print(f"\ntrace -> {trace} (open in chrome://tracing or "
              f"ui.perfetto.dev); phase split:")
        for k, v in sorted(rep.phase_times.items(), key=lambda kv: -kv[1]):
            print(f"  {k:16s} {v:8.3f}s  {v / total:6.1%}")
    n = rep.best.network
    print(f"\n{strategy} best: {rep.best.hardware.name}  "
          f"edp={n.edp:.3e} (cycles={n.cycles:.3e}, "
          f"energy={n.energy_pj:.3e}pJ) after {rep.n_evaluated} evals "
          f"({rep.n_enumerations} mapspace enumerations, "
          f"{rep.n_cache_hits} cache hits)")
    if constraints:
        print(f"feasible: {rep.n_feasible}/{rep.n_evaluated} evaluations "
              f"({rep.feasible_frac:.0%}); {rep.n_skipped_infeasible} "
              f"rejected by static checks before any scoring")
    hv = rep.hypervolume_curve()
    print(f"frontier hypervolume: {hv[-1]:.4f} (normalized; "
          f"{len(rep.pareto)} points)")
    print("Pareto frontier (cycles, energy, area):")
    for p in rep.pareto.summary():
        print(f"  {p['key']:>16s} cycles={p['cycles']:.3e} "
              f"energy={p['energy_pj']:.3e} area={p['area_mm2']:.1f}mm^2")

    full = None
    if compare:
        print(f"\nexhaustive reference over all {space.size} points "
              f"(shares the result cache)...")
        full = run_search(tw, space, goal="edp", cfg=mcfg,
                          strategy="exhaustive", cache=cache, seed=seed,
                          backend=backend, constraints=constraints,
                          device=dev)
        gap = rep.goal_value() / full.goal_value() - 1.0
        ratio = full.n_evaluated / max(rep.n_evaluated, 1)
        print(f"exhaustive best: {full.best.hardware.name}  "
              f"edp={full.goal_value():.3e} after {full.n_evaluated} evals")
        print(f"=> {strategy} used {ratio:.1f}x fewer evaluations for a "
              f"design {gap * 100:.2f}% off the exhaustive optimum "
              f"(target: >=10x fewer, <=5% worse)")
        if ratio >= 10 and gap <= 0.05:
            print("   target met.")
        else:
            print("   target missed on this seed — try --seed/--budget.")
    return rep, full


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", default=None,
                    choices=tuple(sorted(STRATEGIES)),
                    help="run the repro_torch.search engine on a widened "
                         "lattice")
    ap.add_argument("--budget", type=int, default=8,
                    help="architecture-evaluation budget (with --strategy)")
    ap.add_argument("--compare-exhaustive", action="store_true",
                    help="also sweep the full lattice and report the gap")
    ap.add_argument("--max-area", type=float, default=None,
                    help="area budget in mm^2 (constraint area_mm2<=CAP; "
                         "statically infeasible designs are rejected "
                         "before any mapspace scoring)")
    ap.add_argument("--max-power", type=float, default=None,
                    help="average-power budget in watts "
                         "(constraint power_w<=CAP)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="with --strategy: export a Chrome trace of the "
                         "search (chrome://tracing / Perfetto) and print "
                         "the phase-time split")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="mapspace scoring engine (cuda, = auto, routes "
                         "no-bypass mapspaces through the "
                         "kernels/mapspace_eval CUDA kernel, its plain "
                         "version on the CPU; torch is the oracle)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.strategy:
        run_search_dse(args.strategy, args.budget, args.compare_exhaustive,
                       args.seed, args.backend,
                       max_area=args.max_area, max_power=args.max_power,
                       trace=args.trace, device=args.device)
    else:
        run(device=args.device)


if __name__ == "__main__":
    main()
