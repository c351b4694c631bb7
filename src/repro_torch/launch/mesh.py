"""Meshes: the counterpart of the JAX package's ``launch/mesh.py``.

A mesh is a small record: its axis names, its shape (axis -> size) and
its devices. The production topology of the JAX package is described,
not built: single pod 16 x 16 = 256 devices, axes ("data", "model");
multi-pod 2 x 16 x 16 = 512, axes ("pod", "data", "model"), the "pod"
axis the slow cross-pod dimension (batch only, so the one cross-pod
collective in steady state is the gradient all-reduce). Such a mesh has
no devices here.

The port runs on one card: work is placed on a mesh of one device
(:func:`mesh_device`), and a mesh of two or more devices, or one without
devices, is refused with ``NotImplementedError``: the parameter, cache
and optimizer shardings that work needs are ROADMAP queue 1 items 16 and
18, which one H100 cannot check. Importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.distributed.sharding import scenario_mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]                       # axis name -> size
    devices: Tuple[torch.device, ...] = ()      # () for a described mesh

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          devices: Tuple[torch.device, ...] = ()) -> Mesh:
    return Mesh(axes, dict(zip(axes, shape)), devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production topology, without devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1, torch_device: DeviceLike = None) -> Mesh:
    """A ("data", "model") mesh over the local devices of
    ``torch_device``'s type (``None`` = cuda, which raises without a
    GPU; the CPU and ``meta`` count as one device)."""
    devices = scenario_mesh(1, torch_device)
    n = len(devices)
    model = max(1, min(model, n))
    return _mesh((n // model, model), ("data", "model"), devices)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch (pure-DP) axes: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, *names: str) -> int:
    total = 1
    for n in names:
        if n in mesh.axis_names:
            total *= mesh.shape[n]
    return total


def mesh_device(mesh: Optional[Mesh]) -> Optional[torch.device]:
    """The one device work on ``mesh`` is placed on (None for no mesh).
    A mesh of two or more devices, or a described one, raises
    ``NotImplementedError``."""
    if mesh is None:
        return None
    if mesh.size != 1 or len(mesh.devices) != 1:
        raise NotImplementedError(
            f"placing work on a {mesh.size}-device mesh "
            f"{dict(mesh.shape)} is not ported: its parameter, cache and "
            "optimizer shardings need more than one card (ROADMAP, queue "
            "1, items 16 and 18); the port runs on one device")
    return mesh.devices[0]
