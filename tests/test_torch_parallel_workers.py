"""Multi-rank cases of `tests/test_torch_parallel.py`, each run in a
process group of its own: ranks spawned on gloo over a `file://` store in
a temporary directory (no port), on the CPU.  Imports no JAX: the test
computes the reference's numbers and passes them in an npz file.

    python tests/test_torch_parallel_workers.py <case> <in.npz> <out.npz> <world>

Rank 0 writes the case's results to <out.npz>.
"""
from __future__ import annotations

import os
import sys
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa
from repro_torch.train.train_step import (TrainConfig, TrainState,  # noqa
                                          make_train_step)


def _model(cfg, arrays, prefix="state/"):
    """The port model with the reference's parameters (`prefix<name>`
    arrays, float32)."""
    model = init_model(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(arrays[prefix + n]))
    return model


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# --------------------------------------------------------------------------
def case_train(rank, world, a):
    """One train step of the reduced smollm on (2, 2), plain, with 2
    microbatches and with int8 error feedback, against the unsharded
    port step from the same parameters."""
    from repro_torch.parallel.collectives import init_error_state
    cfg = reduced_config("smollm-135m")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    opt = OptConfig(master_fp32=True)
    out = {}
    for tag, tc in (("plain", TrainConfig(remat="none")),
                    ("mb2", TrainConfig(remat="none", microbatches=2)),
                    ("int8", TrainConfig(remat="none",
                                         grad_compression=True))):
        ref = _model(cfg, a)
        st = TrainState(ref, init_opt_state(opt, ref),
                        init_error_state(ref) if tc.grad_compression
                        else None)
        got = _step_pair(cfg, a, mesh, rules, opt, tc, st)
        out.update({f"{tag}_{k}": v for k, v in got.items()})
    return out


def _step_pair(cfg, a, mesh, rules, opt, tc, st) -> dict:
    """One step of the unsharded port from `st` and one of the sharded
    step from the same parameters, on `a["tokens"]`: both losses and grad
    norms, and the largest gap of the updated parameters."""
    spec = ShapeSpec("t", a["tokens"].shape[1], a["tokens"].shape[0],
                     "train")
    st, m_u = make_train_step(cfg, opt, tc)(
        st, {"tokens": torch.from_numpy(a["tokens"])})
    fn, _, tp = steps.build_train_step(cfg, mesh, rules, spec, opt_cfg=opt,
                                       tc=tc)
    params = steps.shard_params(_model(cfg, a), tp.params, mesh)
    sst = steps.init_sharded_state(params, opt, tc, mesh, tp)
    sst, m_s = fn(sst, {"tokens": a["tokens"]})
    err = max(float((_full(p) - q).abs().max()) for p, q in
              zip(sst.params.parameters(), st.params.parameters()))
    return {"loss_plain": float(m_u["loss"]),
            "loss_sharded": float(m_s["loss"]),
            "gnorm_plain": float(m_u["grad_norm"]),
            "gnorm_sharded": float(m_s["grad_norm"]), "param_err": err}


def case_train_family(rank, world, a):
    """One train step of the reduced `a["arch"]` (MoE at capacity factor
    `a["cf"]`) on (2, 2) against the unsharded port step, counting the
    MoE layers that took the expert-parallel path."""
    import dataclasses
    cfg = reduced_config(str(a["arch"]))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(a["cf"]))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    opt = OptConfig(master_fp32=True)
    ep_calls = [0]
    real = sharding.moe_ep_shard_map

    def counted(*args):
        y = real(*args)
        ep_calls[0] += y is not None
        return y

    sharding.moe_ep_shard_map = counted
    ref = _model(cfg, a)
    out = _step_pair(cfg, a, mesh, rules, opt, TrainConfig(remat="none"),
                     TrainState(ref, init_opt_state(opt, ref), None))
    out["ep_calls"] = ep_calls[0]
    return out


def case_decode(rank, world, a):
    """Decode steps of reduced smollm (dense) and granite-moe (the MoE's
    global path at S = 1) on (2, 2) from the reference's parameters."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    out = {}
    for arch in ("smollm-135m", "granite-moe-1b-a400m"):
        cfg = reduced_config(arch)
        toks = a[f"{arch}/tokens"]                 # [steps, B]
        n_steps, b = toks.shape
        max_len = int(a["max_len"])
        spec = ShapeSpec("d", max_len, b, "decode")
        fn, _, (p_pl, c_pl, _) = steps.build_decode_step(cfg, mesh, rules,
                                                         spec)
        params = steps.shard_params(_model(cfg, a, f"{arch}/state/"), p_pl,
                                    mesh)
        cache = steps.place_tree(init_cache(cfg, b, max_len, device="cpu"),
                                 c_pl, mesh)
        logits = []
        for i in range(n_steps):
            lg, cache = fn(params, cache, toks[i], i)
            logits.append(_full(lg).numpy())
        out[arch] = np.stack(logits)
    return out


def case_prefill(rank, world, a):
    """The sharded prefill on (2, 2) of reduced smollm (head dim 64, the
    flash hook installed) and mamba2 (the conv-chain and SSD ops under
    no_grad): each kernel wrapper runs on local shards, so its plain
    version is called on plain (local) tensors once a layer."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_conv import ops as conv_ops
    from repro_torch.models import attention, forward
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    calls = {"flash": 0, "ssd": 0, "conv": 0}

    def counting(mod, name, key):
        real = getattr(mod, name)

        def fn(*args, **kw):
            assert not hasattr(args[0], "device_mesh"), "a DTensor reached " \
                "the plain version"
            calls[key] += 1
            return real(*args, **kw)
        setattr(mod, name, fn)

    counting(flash_ops, "flash_attention_ref", "flash")
    counting(ssd_ops, "ssd_chunk_scan_streaming", "ssd")
    counting(conv_ops, "conv_chain", "conv")
    out = {}
    for arch, changes in (("smollm-135m", {"head_dim": 64}),
                          ("mamba2-2.7b", {})):
        cfg = dataclasses.replace(reduced_config(arch), **changes)
        toks = a[f"{arch}/tokens"]
        b, s = toks.shape
        fn, _, (p_pl, _) = steps.build_prefill_step(
            cfg, mesh, rules, ShapeSpec("p", s, b, "prefill"))
        sharded = steps.shard_params(_model(cfg, a, f"{arch}/state/"), p_pl,
                                     mesh)
        plain = _model(cfg, a, f"{arch}/state/")
        flash_ops.install()
        try:
            before = dict(calls)
            got = _full(fn(sharded, {"tokens": toks}))
            out[f"{arch}/calls"] = np.array(
                [calls[k] - before[k] for k in ("flash", "ssd", "conv")])
            with torch.no_grad():
                want = forward(plain, cfg, {"tokens": torch.from_numpy(toks)},
                               logits_mode="last")
        finally:
            attention.set_flash_impl(None)
        out[f"{arch}/sharded"] = got.numpy()
        out[f"{arch}/plain"] = want.numpy()
    return out


def case_embed(rank, world, a):
    """`masked_embedding_lookup` at model 2 and 4 (and a vocab 4 does not
    divide): values and the table's gradient against the plain gather."""
    from torch.distributed.tensor import DTensor
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        rules = sharding.make_rules(mesh)
        for vocab in (16, 15):
            table = torch.from_numpy(a[f"table{vocab}"])
            toks = torch.from_numpy(a["tokens"])
            w = torch.from_numpy(a["w"])
            pl = sharding.logical_placements(("vocab", None), table.shape,
                                             rules, mesh)
            t_dt = torch.nn.Parameter(sharding.distribute(table, mesh, pl))
            tok_dt = sharding.distribute(
                toks, mesh, sharding.logical_placements(
                    ("batch", None), toks.shape, rules, mesh))
            got = sharding.masked_embedding_lookup(t_dt, tok_dt, mesh, rules)
            loss = (got * DTensor.from_local(
                w, mesh, [sharding.Replicate()] * 2, run_check=False)).sum()
            (g,) = torch.autograd.grad(loss, [t_dt])
            ref_t = table.clone().requires_grad_(True)
            ref = torch.nn.functional.embedding(toks, ref_t)
            (g_ref,) = torch.autograd.grad((ref * w).sum(), [ref_t])
            key = f"{shape[0]}x{shape[1]}_v{vocab}"
            out[key + "_err"] = float((_full(got) - ref).abs().max())
            out[key + "_gerr"] = float((_full(g) - g_ref).abs().max())
            out[key + "_sharded"] = int(any(p.is_shard()
                                            for p in t_dt.placements))
    return out


def case_moe(rank, world, a):
    """The expert-parallel MoE of layer 0 of reduced granite-moe on
    (2, 2), at capacity factors `cf_<i>`."""
    import dataclasses
    cfg0 = reduced_config("granite-moe-1b-a400m")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    x = torch.from_numpy(a["x"])
    out = {}
    for i, cf in enumerate(a["cfs"]):
        cfg = dataclasses.replace(cfg0, capacity_factor=float(cf))
        model = _model(cfg, a)
        _, _, p_pl = steps.param_placements(cfg, mesh, rules)
        steps.shard_params(model, p_pl, mesh)
        x_dt = sharding.distribute(x, mesh, sharding.logical_placements(
            ("batch", "seq", "embed"), x.shape, rules, mesh))
        with torch.no_grad():
            y = sharding.moe_ep_shard_map(model.layers[0].mlp, cfg, x_dt,
                                          mesh, rules)
        out[f"y{i}"] = _full(y).numpy()
    return out


def case_elastic_save(rank, world, a):
    """Shard the reduced smollm on (2, 2), gather it and write it."""
    from repro_torch.train import checkpoint as ckpt
    cfg = reduced_config("smollm-135m")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = sharding.make_rules(mesh)
    _, _, p_pl = steps.param_placements(cfg, mesh, rules)
    model = steps.init_sharded_params(cfg, mesh, p_pl, device="cpu")
    leaves = {n: _full(p) for n, p in model.named_parameters()}
    if rank == 0:
        ckpt.save(str(a["dir"]), 3, leaves)
    dist.barrier()
    return {"n_sharded": sum(any(p.is_shard() for p in pl)
                             for pl in p_pl.values())}


def case_elastic_restore(rank, world, a):
    """Restore that checkpoint onto (1, 2) and (2, 1), bit for bit."""
    from repro_torch.models.layers import param_specs
    from repro_torch.train import checkpoint as ckpt
    cfg = reduced_config("smollm-135m")
    like = init_model(cfg, device="cpu")
    specs = param_specs(like)
    want = ckpt.restore(str(a["dir"]), 3, dict(like.named_parameters()))
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        rules = sharding.make_rules(mesh)
        got = ckpt.restore(str(a["dir"]), 3, dict(like.named_parameters()),
                           mesh=mesh, rules=rules, specs=specs)
        tag = f"{shape[0]}x{shape[1]}"
        out[tag + "_equal"] = int(all(torch.equal(_full(got[n]), want[n])
                                      for n in want))
        out[tag + "_sharded"] = sum(any(p.is_shard() for p in t.placements)
                                    for t in got.values())
    return out


def case_train_loop(rank, world, a):
    """`train_loop` for 3 steps on the mesh `a["mesh"]`, baseline and
    (when asked) with the TRIM overrides; then 3 steps checkpointed into
    `a["ckpt"]` and a second call to 5 steps that resumes from it (the
    losses of steps 3-4, and how many steps each rank ran)."""
    from repro_torch.launch.train import train_loop
    kw = dict(arch="smollm-135m", seq_len=32, global_batch=8,
              mesh_shape=tuple(int(v) for v in a["mesh"]), device="cpu")
    out = {}
    for mode in [str(m) for m in a["modes"]]:
        out[mode] = np.array(train_loop(steps=3, sharding=mode, **kw))
    train_loop(steps=3, ckpt_dir=str(a["ckpt"]), **kw)
    rest = train_loop(steps=5, ckpt_dir=str(a["ckpt"]), **kw)
    lens = [None] * world
    dist.all_gather_object(lens, len(rest))
    out["resume"] = np.array(rest)
    out["resume_lens"] = np.array(lens)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _entry(rank, world, init_file, case, inp, outp):
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=world)
    try:
        res = CASES[case](rank, world, dict(np.load(inp)))
        if rank == 0:
            np.savez(outp, **res)
    finally:
        dist.destroy_process_group()


def run(case: str, inp: str, outp: str, world: int) -> None:
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_entry, args=(world, os.path.join(d, "pg"), case, inp,
                               outp), nprocs=world)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
