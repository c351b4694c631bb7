"""The Pathfinder facade — the public entry point for exploration.

Bundles workload + template + TechDB + normalizer + evaluation device
and drives a :class:`SearchStrategy`::

    from repro_torch.core import workload
    from repro_torch.pathfinding import ParallelTempering, Pathfinder

    pf = Pathfinder(workload(1), "T1")              # runs on cuda
    result = pf.search(ParallelTempering(n_chains=512, sweeps=100), key=0)

``torch_device`` names the torch device of the batched and fused
evaluation; ``None`` means ``cuda`` and raises without a GPU. The
objective backend ``"carbonpath"`` (the full Eqs. 2-17 models) is
ported; ``"chipletgym"`` is a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.evaluate import evaluate
from repro_torch.core.scalesim import SimCache
from repro_torch.core.techdb import DEFAULT_DB, TechDB
from repro_torch.core.templates import TEMPLATES, Normalizer, Template
from repro_torch.core.workload import GEMMWorkload
from repro_torch.pathfinding.batch import fit_normalizer_batched
from repro_torch.pathfinding.space import DesignSpace
from repro_torch.pathfinding.strategies import (
    Objective,
    SearchResult,
    SearchStrategy,
)

OBJECTIVES = {
    "carbonpath": evaluate,
}


class Pathfinder:
    """Carbon-aware design-space exploration over one workload."""

    def __init__(self, wl: GEMMWorkload,
                 template: Union[Template, str] = "T1",
                 db: TechDB = DEFAULT_DB,
                 objective: Union[str, Callable] = "carbonpath",
                 norm: Optional[Normalizer] = None,
                 cache: Optional[SimCache] = None,
                 max_chiplets: int = 6,
                 space: Optional[DesignSpace] = None,
                 device: bool = True,
                 torch_device: DeviceLike = None):
        """``device=True`` (default) routes batched strategies through the
        fused evaluator + tempering engine of
        :mod:`repro_torch.pathfinding.device`; ``device=False`` keeps the
        host path. Either way, batched and fused evaluation run on
        ``torch_device`` (``None`` = cuda)."""
        if objective == "chipletgym":
            raise NotImplementedError(
                "the chipletgym objective is not ported to repro_torch yet "
                "(it comes with the ChipletGym slice)")
        self.wl = wl
        self.template = (TEMPLATES[template] if isinstance(template, str)
                         else template)
        self.db = db
        self.space = space or DesignSpace(db, max_chiplets)
        if callable(objective):
            self.evaluate_fn = objective
        else:
            self.evaluate_fn = OBJECTIVES[objective]
        self.batched = self.evaluate_fn is evaluate
        self.device = bool(device) and self.batched
        self.torch_device = resolve_device(torch_device)
        self.cache = cache if cache is not None else SimCache()
        self._norm = norm

    # -- normalizer ---------------------------------------------------------

    def fit_normalizer(self, samples: int = 2000, seed: int = 1234,
                       method: Optional[str] = None) -> Normalizer:
        """Fit the Eq. 17 min/median normalizer. ``method="batched"``
        (default for the CarbonPATH backend) samples and evaluates the
        population through the array evaluator; ``method="scalar"`` runs
        the scalar ``sa.fit_normalizer`` loop."""
        if method is None:
            method = "batched" if self.batched else "scalar"
        if method == "batched":
            if not self.batched:
                raise ValueError(
                    "batched normalizer fitting requires the carbonpath "
                    "objective backend")
            self._norm = fit_normalizer_batched(
                self.wl, self.db, samples, seed, space=self.space,
                torch_device=self.torch_device)
        elif method == "scalar":
            from repro_torch.core.sa import fit_normalizer
            self._norm = fit_normalizer(
                self.wl, self.db, samples, seed, self.cache,
                self.evaluate_fn, self.space.max_chiplets)
        else:
            raise ValueError(f"unknown normalizer method {method!r}")
        return self._norm

    @property
    def norm(self) -> Normalizer:
        if self._norm is None:
            self.fit_normalizer()
        return self._norm

    # -- search -------------------------------------------------------------

    def objective(self) -> Objective:
        return Objective(self.wl, self.template, self.norm, self.db,
                         self.evaluate_fn, self.cache, self.batched,
                         self.device, self.torch_device)

    def search(self, strategy: SearchStrategy,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        """Run ``strategy`` (the reference's default, simulated
        annealing, is a later slice, so the strategy is required)."""
        return strategy.search(self.space, self.objective(), budget, key)
