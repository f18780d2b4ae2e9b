"""Mesh builders over ``torch.distributed`` (twin of
``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` over the initialised process group with dims
named ``("data", "model")`` or ``("pod", "data", "model")``.  With no
group yet, ``init_world`` starts one: under ``torchrun`` (RANK and
WORLD_SIZE in the environment) from its environment, otherwise a world
of 1 that meets through a file store in a fresh temporary directory, so
that no TCP port is claimed and any number of such processes run side by
side.  NCCL on CUDA, gloo on the CPU, unless the caller names the backend
(gloo over CUDA tensors: several ranks on one card, which NCCL refuses).

Production meshes: single pod 16 x 16 = 256 ranks (data, model); multi-pod
2 x 16 x 16 = 512 (pod, data, model) — the `pod` axis is the slow-link
(DCN) axis carrying data parallelism + pod-sharded ZeRO only.
"""
from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.core.costmodel import MeshShape


def init_world(device=None, backend: Optional[str] = None) -> torch.device:
    """The process group for ``device`` (CUDA unless the caller asks for
    the CPU), started if none is, on ``backend`` (default NCCL on CUDA,
    gloo on the CPU): -> the resolved device (on CUDA this rank's card,
    ``LOCAL_RANK`` under torchrun)."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        store = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_pg_"))
        dist.init_process_group(backend, init_method=f"file://{store}/store",
                                rank=0, world_size=1)
    return dev


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = init_world(device)
    world = dist.get_world_size()
    n = 1
    for k in shape:
        n *= k
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 (data, model) or 2 x 16 x 16 (pod, data, model); raises
    unless the world has 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def mesh_shape_of(mesh) -> MeshShape:
    d = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return MeshShape(data=d.get("data", 1), model=d.get("model", 1),
                     pod=d.get("pod", 1))


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` computes on (its card on CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_host_mesh(n_devices: Optional[int] = None, model: int = 1, *,
                   device=None, backend: Optional[str] = None):
    """A (data, model) mesh over every rank of the world (started as a
    world of 1 on ``backend`` when there is none; ``init_world``),
    factored as (n // model, model).  ``n_devices``, when given, must be
    the world size."""
    dev = init_world(device, backend)
    n = n_devices or dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not factor as (data, {model})")
    return _mesh((n // model, model), ("data", "model"), dev)
