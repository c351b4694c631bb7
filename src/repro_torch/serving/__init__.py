"""Pathfinding as a service: a multi-tenant runtime over the warm
scenario engine (the counterpart of :mod:`repro.serving`).

:class:`PathfinderService` keeps one warm
:class:`~repro_torch.pathfinding.device.ScenarioEngine` on its torch
device and multiplexes many concurrent :class:`JobSpec` searches onto
shape-bucketed slots, advancing everybody one segment at a time; see
:mod:`repro_torch.serving.service` for the scheduling and determinism
contract.
"""
from repro_torch.serving.jobs import (
    JobEvictedError,
    JobResult,
    JobSpec,
    JobState,
    SearchJob,
)
from repro_torch.serving.service import PathfinderService

__all__ = [
    "JobEvictedError",
    "JobResult",
    "JobSpec",
    "JobState",
    "PathfinderService",
    "SearchJob",
]
