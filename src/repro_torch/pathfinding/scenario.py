"""One frozen value for *what to sweep*: :class:`ScenarioSpec`.

The counterpart of :mod:`repro.pathfinding.scenario`. A spec bundles the
workloads, the deployment regions, the design axes (comm / schedule
models) and the run knobs (budget, segment size, checkpointing) of a
scenario sweep. :meth:`repro_torch.pathfinding.pareto.ScenarioSweep.run`
takes a spec in place of its loose ``workloads`` argument, and
:meth:`repro_torch.pathfinding.pathfinder.Pathfinder.run_scenarios` in
place of a sweep. The loose spellings give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.comm import COMM_MODELS
from repro_torch.core.regions import Region, RegionLike, as_region
from repro_torch.core.schedule import SCHEDULE_MODELS
from repro_torch.core.workload import GEMMWorkload


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """What to sweep: workloads x deployment regions, plus the design
    axes (comm / schedule models) and the run knobs (budget, segment
    size, checkpointing).

    ``regions`` accepts a ``{name: Region-or-float}`` mapping (floats
    are scalar-CI regions) and normalizes it to an insertion-ordered
    tuple of ``(name, Region)`` pairs, so the spec is hashable and
    usable as a cache key. ``comm`` / ``schedule`` of ``None`` defer to
    the environment-resolved defaults (``REPRO_COMM_MODEL`` /
    ``REPRO_SCHEDULE``). ``checkpoint_dir`` / ``resume`` make the run
    interruptible (see :meth:`~repro_torch.pathfinding.pareto.
    ScenarioSweep.run`)."""

    workloads: Tuple[GEMMWorkload, ...]
    regions: Tuple[Tuple[str, Region], ...]
    comm: Optional[str] = None
    schedule: Optional[str] = None
    budget: Optional[int] = None
    segment: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = True

    def __post_init__(self) -> None:
        wls = self.workloads
        if isinstance(wls, GEMMWorkload):
            wls = (wls,)
        wls = tuple(wls)
        if not wls or not all(isinstance(w, GEMMWorkload) for w in wls):
            raise ValueError(
                "ScenarioSpec.workloads needs >= 1 GEMMWorkload")
        object.__setattr__(self, "workloads", wls)
        regs = self.regions
        items = regs.items() if isinstance(regs, dict) else regs
        norm = tuple((str(name), as_region(spec)) for name, spec in items)
        if not norm:
            raise ValueError("ScenarioSpec.regions needs >= 1 region")
        object.__setattr__(self, "regions", norm)
        if self.comm is not None and self.comm not in COMM_MODELS:
            raise ValueError(
                f"unknown comm model {self.comm!r}; "
                f"options: {sorted(COMM_MODELS)}")
        if self.schedule is not None \
                and self.schedule not in SCHEDULE_MODELS:
            raise ValueError(
                f"unknown schedule model {self.schedule!r}; "
                f"options: {sorted(SCHEDULE_MODELS)}")

    def region_map(self) -> Dict[str, Region]:
        """The ``{name: Region}`` view (insertion order preserved)."""
        return dict(self.regions)


#: what sweep entry points accept where a region mapping is expected
RegionsLike = Union[Dict[str, RegionLike],
                    Tuple[Tuple[str, Region], ...]]
