"""Guards on the PyTorch/CUDA port (src/repro_torch), chip_smoke.py and
the port's scripts (scripts/*.py):

  * no file imports `jax` or the JAX package `repro` (AST scan);
  * importing the port and every slice module leaves both out of
    `sys.modules` (fresh interpreter);
  * on a host without a card, entry points called without device="cpu"
    raise instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

#: trimlint for the port: the standard library only
ANALYSIS_MODULES = [
    "repro_torch.analysis", "repro_torch.analysis.__main__",
    "repro_torch.analysis.engine", "repro_torch.analysis.baseline",
    "repro_torch.analysis.output", "repro_torch.analysis.rules",
    "repro_torch.analysis.rules.cache_key",
    "repro_torch.analysis.rules.determinism",
    "repro_torch.analysis.rules.registry_cov",
    "repro_torch.analysis.rules.sync",
    "repro_torch.analysis.rules.tracing",
]

SLICE_MODULES = [
    "repro_torch", "repro_torch.convert", "repro_torch.device",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.core", "repro_torch.core.workload",
    "repro_torch.core.designer", "repro_torch.core.mapping",
    "repro_torch.core.mapper", "repro_torch.core.task_analyst",
    "repro_torch.core.evaluator", "repro_torch.core.batch_eval",
    "repro_torch.core.mapspace_array", "repro_torch.core.backend",
    "repro_torch.core.explorer", "repro_torch.kernels",
    "repro_torch.kernels.mapspace_eval",
    "repro_torch.kernels.mapspace_eval.kernel",
    "repro_torch.kernels.mapspace_eval.ref",
    "repro_torch.kernels.mapspace_eval.ops",
    "repro_torch.search", "repro_torch.search.batch_frontier",
    "repro_torch.kernels.build",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.registry", "repro_torch.configs.shapes",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.moe", "repro_torch.models.attention",
    "repro_torch.models.model", "repro_torch.models.ssm",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ssd_scan.kernel",
    "repro_torch.kernels.ssd_scan.ref", "repro_torch.kernels.ssd_scan.ops",
    "repro_torch.serve", "repro_torch.serve.engine",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.core.scheduler", "repro_torch.search.space",
    "repro_torch.search.pareto", "repro_torch.search.constraints",
    "repro_torch.search.strategies", "repro_torch.search.mix",
    "repro_torch.search.cache", "repro_torch.search.driver",
    "repro_torch.obs.progress", "repro_torch.obs.manifest",
    "repro_torch.core.lower_lm", "repro_torch.core.simulator",
    "repro_torch.serve.dse_service", "repro_torch.core.tpu_adapter",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.train",
    "repro_torch.train.optimizer", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.train.resilience",
    "repro_torch.parallel", "repro_torch.parallel.collectives",
    "repro_torch.launch.train",
    "repro_torch.parallel.sharding", "repro_torch.parallel.local_shards",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.steps", "repro_torch.launch.roofline",
    "repro_torch.launch.dryrun", "repro_torch.launch.report",
] + [f"repro_torch.configs.{m}" for m in (
    "deepseek_v2_lite_16b", "granite_moe_1b_a400m", "mamba2_2_7b",
    "minicpm3_4b", "nemotron_4_15b", "phi3_mini_3_8b", "qwen2_vl_2b",
    "smollm_135m", "whisper_small", "zamba2_2_7b")] + ANALYSIS_MODULES


def _imported_roots(path: Path):
    """Top-level package of every absolute import in `path`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_slice_modules_load_without_jax_or_repro():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_analysis_imports_only_the_standard_library():
    """The port's analyzer runs on a bare Python: every absolute import
    in its files is a standard-library module, and importing it and
    running every rule over the repo loads no torch, numpy, jax or
    repro."""
    pkg = PORT / "analysis"
    for path in sorted(pkg.rglob("*.py")):
        bad = [(line, mod) for line, mod in _imported_roots(path)
               if mod not in sys.stdlib_module_names]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    code = ("import sys\n"
            f"for m in {ANALYSIS_MODULES!r}:\n"
            "    __import__(m)\n"
            "from repro_torch.analysis import run_analysis\n"
            f"run_analysis({str(ROOT)!r})\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "bad = top & {'torch', 'numpy', 'jax', 'jaxlib', 'repro'}\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_port_module_is_listed():
    on_disk = {".".join(p.relative_to(PORT.parent).with_suffix("").parts)
               .removesuffix(".__init__") for p in PORT.rglob("*.py")}
    assert on_disk == set(SLICE_MODULES)


def _entry_points():
    import repro_torch.core as tc
    from repro_torch.search import (MapspaceJob, fused_best, fused_launch,
                                    run_search)
    hw = tc.make_spatial_arch(num_pes=64, rf_words=128,
                              gbuf_words=16 * 1024, bits=16)
    wl = tc.analyze(tc.alexnet_cifar(batch_size=4)).intra[2]
    pm = tc.build_packed_mapspace(wl, hw, tc.MapperConfig(max_mappings=80))
    task = tc.alexnet_cifar(batch_size=4)
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import main_dse, main_lm
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_model
    from repro_torch.serve import DSEService, ServeEngine
    lm = reduced_config("smollm-135m")
    serve_args = ["--requests", "2", "--max-new-tokens", "2"]
    dse_args = ["--clients", "2", "--budget", "1", "--distinct", "0"]
    cli = lambda kw: [a for k, v in kw.items() for a in (f"--{k}", v)]
    return {
        "init_model": lambda **kw: init_model(lm, **kw),
        "ServeEngine": lambda **kw: ServeEngine(lm, None, **kw),
        "main_lm": lambda **kw: main_lm(serve_args + cli(kw)),
        "DSEService": lambda **kw: DSEService(workers=1, **kw).close(),
        "main_dse": lambda **kw: main_dse(dse_args + cli(kw)),
        "explore": lambda **kw: tc.explore(
            task, [hw], cfg=tc.MapperConfig(max_mappings=80), **kw),
        "score_mapspace": lambda **kw: tc.score_mapspace(pm, **kw),
        "best_index": lambda **kw: tc.best_index(pm, **kw),
        "fused_best": lambda **kw: fused_best(
            [MapspaceJob(tag=0, hw=hw, workload=wl, packed=pm)], **kw),
        "fused_launch": lambda **kw: fused_launch(
            [MapspaceJob(tag=0, hw=hw, workload=wl, packed=pm)], **kw),
        "run_search": lambda **kw: run_search(
            task, [hw], cfg=tc.MapperConfig(max_mappings=80), **kw),
        "train_loop": lambda **kw: train_loop(
            arch="smollm-135m", steps=1, seq_len=8, global_batch=2,
            log_every=50, **kw),
    }


@pytest.mark.parametrize("name", ["explore", "score_mapspace", "best_index",
                                  "fused_best", "fused_launch", "run_search",
                                  "init_model", "ServeEngine", "main_lm",
                                  "DSEService", "main_dse", "train_loop"])
def test_no_silent_cpu_fallback(name):
    fn = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("host has a CUDA device: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")            # the explicit host run works
