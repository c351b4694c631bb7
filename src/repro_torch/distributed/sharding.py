"""Scenario-axis placement: the torch stand-in for the JAX package's
``scenario_mesh`` / ``shard_scenarios`` (``distributed/sharding.py``).

A mesh here is the tuple of local devices of one type, the counterpart
of the reference's 1-D ``('data',)`` mesh. On one device, placing the
scenario arrays is putting each on that device, as the reference's
``fit_spec`` does with a data axis of size 1. Splitting the scenario
axis over several cards is not ported (ROADMAP, queue 1, item 11): it
cannot be checked on one H100, so a mesh of more than one device is
refused rather than run. The parameter, cache and optimizer specs of
the reference module belong to training and are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device

Mesh = Tuple[torch.device, ...]


def scenario_mesh(min_devices: int = 2,
                  torch_device: DeviceLike = None) -> Optional[Mesh]:
    """The local devices of ``torch_device``'s type (``None`` = cuda,
    which raises without a GPU), or ``None`` when there are fewer than
    ``min_devices`` of them. The CPU counts as one device."""
    dev = resolve_device(torch_device)
    if dev.type == "cuda":
        mesh = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    else:
        mesh = (torch.device(dev.type),)
    return mesh if len(mesh) >= min_devices else None


def shard_scenarios(arrays: Dict[str, object],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each array (numpy or torch) as a tensor on the mesh's one device,
    dtype kept. A mesh of several devices raises
    ``NotImplementedError``: the split of the leading (scenario) axis
    over cards is not ported."""
    if len(mesh) != 1:
        raise NotImplementedError(
            f"sharding the scenario axis over {len(mesh)} devices is not "
            "ported (ROADMAP, queue 1, item 11); one device runs")
    return {k: torch.as_tensor(x, device=mesh[0]) for k, x in arrays.items()}
