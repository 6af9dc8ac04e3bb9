"""The five examples of the PyTorch/CUDA port (`examples/port/*.py`)
against the JAX package's own functions on the CPU, at small sizes.

The JAX example scripts are slow on the CPU and are not run: each port
example's `run` function is called with `device="cpu"`, and the JAX
functions the JAX example calls get the same inputs directly.

  * quickstart and explore_training_asic (AlexNet-CIFAR at batch 4, two
    architectures, 300 mappings): the same winner, cycles, energy and EDP
    within rtol 2e-4 and the same rendered mapping; for
    explore_training_asic also the zero-skip gain within 2e-4.  The
    reference runs with `use_batch=False`, its float64 scalar evaluator:
    its jnp batch path spends about a minute compiling on the CPU, and
    `tests/test_torch_explorer.py` already holds the port's exploration
    to it;
  * dse_modern_lm: the block report's optimal mappings (the same
    mapping, cycles within 2e-4) and `plan_cell`'s plans (exact) equal
    the reference's; `run_search_dse` gives the same best, number of
    evaluations and frontier hypervolume as the reference's `run_search`
    with its jnp engine (anneal at budget 3; the bandit at budget 4 under
    an area and a power cap);
  * serve_lm (reduced smollm-135m, the weights of the reference's
    `init_model(cfg, PRNGKey(0))` converted): the same `out_tokens` for
    every request as the reference's `ServeEngine`;
  * train_lm: a few steps, losses finite and falling, and a run resumed
    from a checkpoint reproduces the losses of the uninterrupted run
    exactly.  The reference's `train_loop` cannot run here (`jax.make_mesh`
    makes `Explicit` axes, which its sharding constraints refuse; ROADMAP
    queue 3), so there is no reference run: the port's train step is held
    to the reference's `make_train_step` in `tests/test_torch_train.py`.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core as rc
from repro.configs import SHAPES as R_SHAPES, get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.configs.shapes import ShapeSpec as RShapeSpec
from repro.core.lower_lm import lower_block as r_lower_block
from repro.core.task_analyst import TaskWorkloads as RTaskWorkloads
from repro.core.tpu_adapter import plan_cell as r_plan_cell
from repro.models import init_model as r_init_model
from repro.search import ArchSpace as RArchSpace
from repro.search import ResultCache as RResultCache
from repro.search import run_search as r_run_search
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-4
QUICKSTART_SPACE = dict(num_pes=(64, 256), rf_words=(128,),
                        gbuf_words=(32 * 1024,), bits=32, zero_skip=True)
ASIC_SPACE = dict(num_pes=(256, 512), rf_words=(128,),
                  gbuf_words=(64 * 1024,), bits=32, zero_skip=True)


def _example(name: str):
    path = ROOT / "examples" / "port" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _network(arch_result):
    n = arch_result.network
    return [n.cycles, n.energy_pj, n.edp]


def _same_winner(port, ref):
    assert port.best.hardware.name == ref.best.hardware.name
    assert [a.hardware.name for a in port.all_archs] == \
        [a.hardware.name for a in ref.all_archs]
    for pa, ra in zip(port.all_archs, ref.all_archs):
        np.testing.assert_allclose(_network(pa), _network(ra), rtol=RTOL)
    for pw, rw in zip(port.best.per_workload, ref.best.per_workload):
        assert pw.mapping.render() == rw.mapping.render(), \
            pw.workload.name


def test_quickstart_matches_reference(capsys):
    port = _example("quickstart").run(batch_size=4, max_mappings=300,
                                      arch_space=QUICKSTART_SPACE,
                                      device="cpu")
    printed = capsys.readouterr().out
    cfg = rc.MapperConfig(max_mappings=300, seed=0, pe_utilization_min=0.5)
    ref = rc.explore(rc.alexnet_cifar(batch_size=4),
                     list(rc.generate_arch_space(**QUICKSTART_SPACE)),
                     goal="edp", cfg=cfg, use_batch=False)
    _same_winner(port, ref)
    assert f"optimal architecture: {ref.best.hardware.name}" in printed
    assert ref.best.per_workload[0].mapping.render() in printed
    assert printed.count(" cycles=") == 2          # one line an arch


def test_explore_training_asic_matches_reference(capsys):
    port = _example("explore_training_asic").run(
        batch_size=4, max_mappings=300, arch_space=ASIC_SPACE, device="cpu")
    printed = capsys.readouterr().out
    cfg = rc.MapperConfig(max_mappings=300, seed=0)
    task = rc.alexnet_cifar(batch_size=4)
    ref = rc.explore(task, list(rc.generate_arch_space(**ASIC_SPACE)),
                     goal="edp", cfg=cfg, use_batch=False)
    _same_winner(port["explore"], ref)
    tw = rc.analyze(task)
    best = ref.best.hardware
    on = rc.evaluate_architecture(tw, best, cfg, goal="energy",
                                  use_batch=False)
    off = rc.evaluate_architecture(
        tw, dataclasses.replace(best, zero_skip_level=None), cfg,
        goal="energy", use_batch=False)
    gain = off.network.energy_per_mac_pj / on.network.energy_per_mac_pj
    assert gain > 1.0
    np.testing.assert_allclose(port["gain"], gain, rtol=RTOL)
    np.testing.assert_allclose(_network(port["on"]), _network(on),
                               rtol=RTOL)
    np.testing.assert_allclose(_network(port["off"]), _network(off),
                               rtol=RTOL)
    assert f"zero-skipping energy gain on winner: {gain:.2f}x" in printed


def test_dse_modern_lm_block_report_matches_reference(capsys):
    port = _example("dse_modern_lm").run(top_k=3, max_mappings=300,
                                         device="cpu")
    printed = capsys.readouterr().out
    cfg = r_get_config("deepseek-v2-lite-16b")
    lowered = r_lower_block(cfg, RShapeSpec("small_train", 512, 8, "train"))
    assert len(port["lowered"].workloads) == len(lowered.workloads)
    assert port["lowered"].total_macs() == lowered.total_macs()
    top = sorted(lowered.workloads, key=lambda w: -w.macs)[:3]
    hw = rc.make_spatial_arch(num_pes=1024, rf_words=512,
                              gbuf_words=512 * 1024, bits=16,
                              zero_skip=False)
    mcfg = rc.MapperConfig(max_mappings=300, seed=0, pe_utilization_min=0.5)
    assert len(port["mappings"]) == 3
    for (pwl, pr), wl in zip(port["mappings"], top):
        rr = rc.find_optimal_mapping(wl, hw, mcfg, goal="latency",
                                     use_batch=False)
        assert (pwl.name, pwl.dims) == (wl.name, wl.dims)
        assert pr.mapping.render() == rr.mapping.render(), wl.name
        np.testing.assert_allclose(
            [pr.estimate.cycles, pr.estimate.pe_utilization],
            [rr.estimate.cycles, rr.estimate.pe_utilization], rtol=RTOL)
    plans = r_plan_cell(cfg, R_SHAPES["train_4k"], data_par=32,
                        model_par=16)
    assert {k: (v.data_dim, v.model_dim, v.cycles, v.macs)
            for k, v in port["plans"].items()} == \
        {k: (v.data_dim, v.model_dim, v.cycles, v.macs)
         for k, v in plans.items()}
    assert "TRIM sharding plan for the production pod" in printed


@pytest.mark.parametrize("strategy,budget,caps", [
    ("anneal", 3, {}),
    ("bandit", 4, {"max_area": 400.0, "max_power": 30.0})],
    ids=["anneal", "bandit-capped"])
def test_dse_modern_lm_search_matches_reference(capsys, strategy, budget,
                                                caps):
    ex = _example("dse_modern_lm")
    port, full = ex.run_search_dse(strategy, budget, False,
                                   max_mappings=200, device="cpu", **caps)
    printed = capsys.readouterr().out
    assert full is None
    _, tw = ex.lm_task_workloads()
    r_top = sorted(r_lower_block(r_get_config("deepseek-v2-lite-16b"),
                                 RShapeSpec("small_train", 512, 8,
                                            "train")).workloads,
                   key=lambda w: -w.macs)[:3]
    assert [w.name for w in tw.intra] == [w.name for w in r_top]
    constraints = [f"{m}<={caps[k]}" for k, m in
                   (("max_area", "area_mm2"), ("max_power", "power_w"))
                   if k in caps] or None
    ref = r_run_search(
        RTaskWorkloads(intra=r_top, preproc=[], activations=[]),
        RArchSpace.spatial(bits=16, zero_skip=False, **ex.SEARCH_LATTICE),
        goal="edp", strategy=strategy, budget=budget,
        cfg=rc.MapperConfig(max_mappings=200, seed=0,
                            pe_utilization_min=0.5),
        cache=RResultCache(), seed=0, backend="jnp",
        constraints=constraints)
    assert port.best.hardware.name == ref.best.hardware.name
    assert port.n_evaluated == ref.n_evaluated
    assert [h["arch"] for h in port.history] == \
        [h["arch"] for h in ref.history]
    np.testing.assert_allclose(port.hypervolume_curve()[-1],
                               ref.hypervolume_curve()[-1], rtol=RTOL)
    np.testing.assert_allclose(port.goal_value(), ref.goal_value(),
                               rtol=RTOL)
    assert f"{strategy} best: {ref.best.hardware.name}" in printed


def test_serve_lm_matches_reference(capsys):
    cfg = r_reduced_config("smollm-135m")
    params, _ = r_init_model(cfg, jax.random.PRNGKey(0))
    ref = RServeEngine(cfg, params, batch=4, max_len=64)
    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(2, 8))
        ref.submit(RRequest(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=8))
    ref.run_until_drained()
    tree = jax.tree_util.tree_map(np.asarray, params)
    done = _example("serve_lm").run(tree=tree, device="cpu")
    printed = capsys.readouterr().out
    assert sorted(done) == sorted(ref.done) == list(range(8))
    for rid in range(8):
        assert list(done[rid].prompt) == list(ref.done[rid].prompt)
        assert done[rid].out_tokens == ref.done[rid].out_tokens, rid
        assert f"  req {rid}: prompt[{len(done[rid].prompt)}] -> " \
            f"{ref.done[rid].out_tokens}" in printed


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    ex = _example("train_lm")
    kw = dict(steps=12, seq_len=32, global_batch=4, device="cpu")
    losses = ex.run(ckpt_dir=str(tmp_path), **kw)
    assert len(losses) == 12
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert "OK: loss decreased over training" in capsys.readouterr().out
    # checkpoints at step 10 (every max(12 // 4, 10) steps) and 12: point
    # LATEST back at 10 and run again to 12
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_10", "step_12"]
    (tmp_path / "LATEST").write_text("10")
    resumed = ex.run(ckpt_dir=str(tmp_path), **kw)
    printed = capsys.readouterr().out
    assert "[train] resumed from step 10" in printed
    assert "resumed at step 10: 2 steps run" in printed
    assert resumed == losses[10:]
    # at its last step already: nothing to run
    assert ex.run(ckpt_dir=str(tmp_path), **kw) == []
