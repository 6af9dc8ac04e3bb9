"""The port's sharded paths across ranks, on the CPU: each case spawns its
ranks on gloo (`tests/test_torch_parallel_workers.py`, no JAX there) under a
subprocess timeout of its own; the JAX package's single-device numbers are
computed here and passed in.

The reference's own sharded tests (`tests/test_distributed.py`) fail on
this JAX at `with_sharding_constraint`, so the port is held to the
reference's single-device results, and to its own unsharded step.

Tolerances (float32, reduced configs):
  * sharded train step (smollm; granite-moe on the expert-parallel and
    the global MoE path; mamba2): loss within 5e-3 relative of the
    reference's single-device step (the bound of the reference's own
    sharded test) and within 1e-5 relative of the port's unsharded step;
    grad norm 1e-5 relative; gathered updated params within 1e-5 abs;
  * sharded decode logits within 1e-4 abs of the reference's
    `decode_step` (float32 sums over shards in another order); sharded
    prefill logits (flash, SSD and conv-chain wrappers on local shards,
    their plain versions on the CPU) within 1e-5 of the port's unsharded
    prefill and 1e-4 of the reference's;
  * masked embedding lookup: values exact, table gradient 1e-6;
  * expert-parallel MoE: 1e-5 relative and absolute (outputs reach ~100;
    the batched expert products sum in another order) against the
    reference's global path where nothing drops, and against the reference's local route /
    expert FFN / combine composed per shard at the default factor;
  * elastic restore: bit for bit;
  * `train_loop` on (2, 2), baseline and TRIM, and resumed from its
    checkpoint on every rank: losses within 1e-5 relative of (1, 1).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.train import optimizer as jax_opt
from repro.train import train_step as jax_ts
from repro_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(ROOT, "tests", "test_torch_parallel_workers.py")


@pytest.fixture(autouse=True)
def _reference_hooks_off():
    jax_layers.set_shard_fn(None)
    jax_layers.set_embed_lookup(None)
    jax_attention.set_flash_impl(None)
    jax_moe.set_moe_ep_impl(None)


def run_case(tmp_path, case: str, arrays: dict, world: int = 4,
             timeout: int = 300) -> dict:
    inp, outp = tmp_path / f"{case}_in.npz", tmp_path / f"{case}_out.npz"
    np.savez(inp, **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, WORKERS, case, str(inp), str(outp),
                        str(world)], capture_output=True, text=True,
                       timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(outp))


def _ref_params(arch, prefix="state/", **changes):
    cfg = dataclasses.replace(jax_reduced_config(arch), **changes)
    params, _ = jax_init_model(cfg, jax.random.PRNGKey(0))
    flat = convert.model_state_from_tree(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    return cfg, params, {prefix + k: v for k, v in flat.items()}


def test_sharded_train_step_matches_single_device(tmp_path):
    cfg, params, arrays = _ref_params("smollm-135m")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)) \
        .astype(np.int64)
    opt = jax_opt.OptConfig(master_fp32=True)
    st = jax_ts.TrainState(params, jax_opt.init_opt_state(opt, params), None)
    _, m = jax.jit(jax_ts.make_train_step(
        cfg, opt, jax_ts.TrainConfig(remat="none")))(
            st, {"tokens": jnp.asarray(toks, jnp.int32)})
    ref_loss = float(m["loss"])
    got = run_case(tmp_path, "train", dict(arrays, tokens=toks))
    for tag in ("plain", "mb2", "int8"):
        ls, lp = float(got[f"{tag}_loss_sharded"]), \
            float(got[f"{tag}_loss_plain"])
        assert abs(ls - ref_loss) <= 5e-3 * abs(ref_loss), (tag, ls, ref_loss)
        assert abs(ls - lp) <= 1e-5 * abs(lp), (tag, ls, lp)
        gs, gp = float(got[f"{tag}_gnorm_sharded"]), \
            float(got[f"{tag}_gnorm_plain"])
        assert abs(gs - gp) <= 1e-5 * abs(gp), (tag, gs, gp)
        assert float(got[f"{tag}_param_err"]) <= 1e-5, tag


@pytest.mark.parametrize("arch,seq,cf,path", [
    # nothing drops at 64: the expert-parallel path (local capacity)
    # equals the global one
    ("granite-moe-1b-a400m", 32, 64.0, "ep"),
    # S = 31 does not divide over model: the global path
    # (`replicated_call` routing) at the default factor, with drops
    ("granite-moe-1b-a400m", 31, 0.0, "global"),
    ("mamba2-2.7b", 32, 0.0, "ssm"),
])
def test_sharded_train_step_families(tmp_path, arch, seq, cf, path):
    changes = {"capacity_factor": cf} if cf else {}
    cfg, params, arrays = _ref_params(arch, **changes)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (8, seq)) \
        .astype(np.int64)
    opt = jax_opt.OptConfig(master_fp32=True)
    st = jax_ts.TrainState(params, jax_opt.init_opt_state(opt, params), None)
    _, m = jax.jit(jax_ts.make_train_step(
        cfg, opt, jax_ts.TrainConfig(remat="none")))(
            st, {"tokens": jnp.asarray(toks, jnp.int32)})
    ref_loss = float(m["loss"])
    got = run_case(tmp_path, "train_family",
                   dict(arrays, tokens=toks, arch=np.array(arch),
                        cf=np.float64(cf or cfg.capacity_factor)))
    ls, lp = float(got["loss_sharded"]), float(got["loss_plain"])
    assert abs(ls - ref_loss) <= 5e-3 * abs(ref_loss), (ls, ref_loss)
    assert abs(ls - lp) <= 1e-5 * abs(lp), (ls, lp)
    gs, gp = float(got["gnorm_sharded"]), float(got["gnorm_plain"])
    assert abs(gs - gp) <= 1e-5 * abs(gp), (gs, gp)
    assert float(got["param_err"]) <= 1e-5
    # the EP path once a MoE layer, or never
    n_ep = cfg.n_layers if path == "ep" else 0
    assert int(got["ep_calls"]) == n_ep, path


def test_sharded_decode_matches_reference(tmp_path):
    arrays, want = {"max_len": np.int64(16)}, {}
    rng = np.random.default_rng(2)
    for arch in ("smollm-135m", "granite-moe-1b-a400m"):
        cfg, params, st = _ref_params(arch, prefix=f"{arch}/state/")
        arrays.update(st)
        toks = rng.integers(0, cfg.vocab, (3, 4)).astype(np.int64)
        arrays[f"{arch}/tokens"] = toks
        cache = jax_init_cache(cfg, 4, 16)
        logits = []
        for i in range(toks.shape[0]):
            lg, cache = jax_decode_step(params, cfg, cache,
                                        jnp.asarray(toks[i], jnp.int32), i)
            logits.append(np.asarray(lg, np.float32))
        want[arch] = np.stack(logits)
    got = run_case(tmp_path, "decode", arrays)
    for arch, w in want.items():
        np.testing.assert_allclose(got[arch], w, rtol=0, atol=1e-4,
                                   err_msg=arch)


def test_sharded_prefill_runs_the_kernel_wrappers_on_local_shards(tmp_path):
    arrays, want, cfgs = {}, {}, {}
    rng = np.random.default_rng(5)
    for arch, changes in (("smollm-135m", {"head_dim": 64}),
                          ("mamba2-2.7b", {})):
        cfg, params, st = _ref_params(arch, prefix=f"{arch}/state/",
                                      **changes)
        arrays.update(st)
        toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)
        arrays[f"{arch}/tokens"] = toks
        want[arch] = np.asarray(jax_forward(
            params, cfg, {"tokens": jnp.asarray(toks, jnp.int32)},
            logits_mode="last"), np.float32)
        cfgs[arch] = cfg
    got = run_case(tmp_path, "prefill", arrays)
    for arch, w in want.items():
        n = cfgs[arch].n_layers
        flash, ssd, conv = got[f"{arch}/calls"]
        # every rank calls each plain version once a layer, on its shard
        assert (flash, ssd, conv) == ((n, 0, 0) if arch == "smollm-135m"
                                      else (0, n, n))
        np.testing.assert_allclose(got[f"{arch}/sharded"],
                                   got[f"{arch}/plain"], rtol=0, atol=1e-5,
                                   err_msg=arch)
        np.testing.assert_allclose(got[f"{arch}/sharded"], w, rtol=0,
                                   atol=1e-4, err_msg=arch)


def test_masked_embedding_lookup(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"table16": rng.standard_normal((16, 8)).astype(np.float32),
              "table15": rng.standard_normal((15, 8)).astype(np.float32),
              "tokens": rng.integers(0, 15, (4, 6)).astype(np.int64),
              "w": rng.standard_normal((4, 6, 8)).astype(np.float32)}
    got = run_case(tmp_path, "embed", arrays)
    for key in ("2x2", "1x4"):
        assert int(got[f"{key}_v16_sharded"]) == 1       # vocab-sharded
        assert int(got[f"{key}_v15_sharded"]) == 0       # replicated
        for v in (16, 15):
            assert float(got[f"{key}_v{v}_err"]) == 0.0, (key, v)
            assert float(got[f"{key}_v{v}_gerr"]) <= 1e-6, (key, v)


def _moe_p(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"])["mlp"]


def test_moe_expert_parallel(tmp_path):
    cfg0, params, arrays = _ref_params("granite-moe-1b-a400m")
    b, s = 4, 8
    x = np.random.default_rng(4).standard_normal(
        (b, s, cfg0.d_model)).astype(np.float32)
    cfs = np.array([64.0, cfg0.capacity_factor])
    got = run_case(tmp_path, "moe", dict(arrays, x=x, cfs=cfs))
    p = _moe_p(params)
    # nothing drops at 64: the global path's result
    cfg = dataclasses.replace(cfg0, capacity_factor=64.0)
    want = np.asarray(jax_moe._moe_mlp_global(p, cfg, jnp.asarray(x)))
    if cfg.n_shared_experts:
        want = want - np.asarray(jax_moe.dense_mlp(p["shared"], cfg,
                                                   jnp.asarray(x)))
    np.testing.assert_allclose(got["y0"], want, rtol=1e-5, atol=1e-5)
    # default factor: each (data, model) shard routes its own slab with
    # the capacity of its local token count
    cfg = cfg0
    n_dp = ep = 2
    t_loc = (b // n_dp) * (s // ep)
    cap = int(max(cfg.top_k, (t_loc * cfg.top_k * cfg.capacity_factor)
                  // cfg.n_experts))
    want = np.zeros_like(x)
    for di in range(n_dp):
        for mi in range(ep):
            rows = slice(di * b // n_dp, (di + 1) * b // n_dp)
            cols = slice(mi * s // ep, (mi + 1) * s // ep)
            xt = jnp.asarray(x[rows, cols].reshape(-1, cfg.d_model))
            buf, route = jax_moe.moe_local_route_dispatch(xt, p["router"],
                                                          cfg, cap)
            out = jax_moe.expert_ffn(buf, p, cfg)
            y = jax_moe.moe_combine(out, route, xt.shape[0], cfg.top_k,
                                    cfg.d_model, cap)
            want[rows, cols] = np.asarray(y).reshape(b // n_dp, s // ep, -1)
    np.testing.assert_allclose(got["y1"], want, rtol=1e-5, atol=1e-5)


def test_elastic_restore_onto_new_meshes(tmp_path):
    d = str(tmp_path / "ckpt")
    saved = run_case(tmp_path, "elastic_save", {"dir": np.array(d)})
    assert int(saved["n_sharded"]) > 0
    got = run_case(tmp_path, "elastic_restore", {"dir": np.array(d)},
                   world=2)
    for key in ("1x2", "2x1"):
        assert int(got[f"{key}_equal"]) == 1, key
        assert int(got[f"{key}_sharded"]) > 0, key


def test_train_loop_on_mesh_matches_one_device(tmp_path):
    on_mesh = run_case(tmp_path, "train_loop",
                       {"mesh": np.array([2, 2]),
                        "modes": np.array(["baseline", "trim"]),
                        "ckpt": np.array(str(tmp_path / "ck22"))},
                       timeout=400)
    one = run_case(tmp_path, "train_loop",
                   {"mesh": np.array([1, 1]),
                    "modes": np.array(["baseline"]),
                    "ckpt": np.array(str(tmp_path / "ck11"))}, world=1)
    for mode in ("baseline", "trim"):
        assert on_mesh[mode].shape == (3,)
        np.testing.assert_allclose(on_mesh[mode], one["baseline"],
                                   rtol=1e-5, err_msg=mode)
    # every rank resumed from the checkpoint at step 3
    assert on_mesh["resume_lens"].tolist() == [2] * 4
    np.testing.assert_allclose(on_mesh["resume"], one["resume"], rtol=1e-5)
