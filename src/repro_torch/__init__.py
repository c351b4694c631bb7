"""CarbonPATH in PyTorch: the design-space search of :mod:`repro` ported
to torch tensors and hand-written CUDA kernels for Hopper.

Layout mirrors the JAX package (``core``, ``pathfinding``, ``kernels``)
so every module has a same-named counterpart. This package imports
nothing of ``jax`` or of ``repro``; :mod:`repro_torch.convert` turns
state saved by the reference (plain arrays and dicts) into this
package's objects.

Device rule: every entry point takes a ``torch_device`` keyword. ``None``
means ``cuda``, and raises when no CUDA device is present; the CPU is
used only when the caller asks for it (``torch_device="cpu"``). The
engine path computes in float64 throughout.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(torch_device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the
    caller names another. Never falls back to the CPU on its own."""
    if torch_device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass torch_device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(torch_device)


__all__ = ["DeviceLike", "resolve_device"]
