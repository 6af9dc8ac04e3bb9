"""Mesh construction on `torch.distributed` (the port of the JAX package's
`launch/mesh.py`).

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); the pod axis
carries pure data parallelism.

`make_mesh` starts the default process group when none exists: from
`RANK`/`WORLD_SIZE` (and torchrun's `MASTER_ADDR`/`MASTER_PORT`) when they
are set, otherwise as a world of one process over an in-process store.  A
"cuda" mesh runs on NCCL with each rank on `cuda:<LOCAL_RANK>`, a "cpu"
mesh on gloo; a "cuda" mesh on a gloo group raises.  Functions only, so
importing this module starts nothing.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import as_device


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device="cuda") -> None:
    """Start the default process group for `device`'s type unless one
    exists; raise when the existing one cannot serve it."""
    dev = as_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if dev.type == "cuda" and backend == "gloo":
            raise RuntimeError("a cuda mesh needs an NCCL process group; "
                               "the default group runs on gloo")
        return
    backend = _backend(dev.type)
    kwargs = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device="cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` over the world's ranks, axes named
    `axes`.  Raises when the mesh's size differs from the world's."""
    dev = as_device(device)
    ensure_process_group(dev)
    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_test_mesh(model: int = 2, *, device="cpu") -> DeviceMesh:
    """(data, model) mesh over every rank of the world (data = world /
    model), for CPU integration tests on gloo."""
    ensure_process_group(device)
    world = dist.get_world_size()
    return make_mesh((world // model, model), ("data", "model"),
                     device=device)
