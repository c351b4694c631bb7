"""Meshes: the counterpart of the JAX package's ``launch/mesh.py``.

A mesh over ranks is a ``torch.distributed.device_mesh.DeviceMesh``
with the JAX package's axis names:

- :func:`make_host_mesh` builds a ``("data", "model")`` mesh over the
  ranks of the live process group (one process per device, as
  ``python -m torch.distributed.run`` starts them), on the caller's
  device type. Without a group it is the small :class:`Mesh` record of
  the one local device, and work on it runs as it does without a mesh.
- :func:`make_production_mesh` builds the production topology over a
  fake process group of 256 or 512 ranks (no device; the dry-run counts
  one rank's shards on ``meta``): single pod 16 x 16, axes ("data",
  "model"); multi-pod 2 x 16 x 16, axes ("pod", "data", "model"), the
  "pod" axis the slow cross-pod dimension (batch only, so the one
  cross-pod collective in steady state is the gradient all-reduce).

:func:`data_axes` and :func:`axis_size` read either kind. Importing this
module touches no device and starts no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The one-device mesh of a run without a process group."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]                       # axis name -> size
    devices: Tuple[torch.device, ...] = ()

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (work on it is placed as
    DTensors), not the one-device record."""
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def _init_fake_group(world_size: int) -> None:
    """Start (or check) the fake process group of ``world_size`` ranks
    this process is rank 0 of."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is live; "
                f"the production mesh needs a fake group of {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production topology as a ``DeviceMesh`` over a
    fake process group of 256 (or 512) ranks, started here if none is
    live. This process is rank 0; its collectives complete at once
    without moving data, and tensors on it live on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _init_fake_group(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, torch_device: DeviceLike = None):
    """A ("data", "model") ``DeviceMesh`` over the ranks of the live
    process group, ``model`` of them (at most the world size) per model
    group, on ``torch_device``'s type (``None`` = cuda, which raises
    without a GPU). Without a group, the one-device :class:`Mesh` of
    ``torch_device`` (the CPU and ``meta`` count as one device)."""
    import torch.distributed as dist

    dev = resolve_device(torch_device)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        n = dist.get_world_size()
        model = max(1, min(model, n))
        if n % model:
            raise ValueError(f"--model-par {model} does not divide the "
                             f"{n} ranks")
        kind = "cpu" if dev.type == "meta" else dev.type
        return init_device_mesh(kind, (n // model, model),
                                mesh_dim_names=("data", "model"))
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(("data", "model"), {"data": 1, "model": 1}, (dev,))


def init_from_env(device: torch.device) -> Optional[torch.device]:
    """Join the process group that ``python -m torch.distributed.run``
    describes in the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``): gloo on the CPU, nccl on cuda,
    each rank on card ``LOCAL_RANK``. Returns this rank's device, or
    None (and starts nothing) without that environment or when a group
    is live already."""
    import os

    import torch.distributed as dist

    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ \
            or dist.is_initialized():
        return None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch (pure-DP) axes: ('pod', 'data') on multi-pod meshes."""
    return shd.data_axes(mesh)


def axis_size(mesh, *names: str) -> int:
    sizes = shd.mesh_axes(mesh)
    total = 1
    for n in names:
        total *= sizes.get(n, 1)
    return total


def mesh_device(mesh) -> Optional[torch.device]:
    """The device this rank places its work on (None for no mesh): the
    one-device mesh's device, or this rank's device of a ``DeviceMesh``
    (``meta`` under a fake group, whose ranks hold no device)."""
    if mesh is None:
        return None
    if not is_device_mesh(mesh):
        return mesh.devices[0]
    import torch.distributed as dist

    if dist.get_backend() == "fake":
        return torch.device("meta")
    return shd.mesh_device_of(mesh)
