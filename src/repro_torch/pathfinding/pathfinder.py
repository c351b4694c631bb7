"""The Pathfinder facade — the public entry point for exploration.

Bundles workload + template + TechDB + objective backend + normalizer +
evaluation device and drives a :class:`SearchStrategy`::

    from repro_torch.core import workload
    from repro_torch.pathfinding import ParallelTempering, Pathfinder

    pf = Pathfinder(workload(1), "T1")              # runs on cuda
    result = pf.search(ParallelTempering(n_chains=512, sweeps=100), key=0)
    front = pf.pareto_front()                       # ScalarizationSweep
    grid = pf.run_scenarios(workloads=[workload(1), workload(6)])

``torch_device`` names the torch device of the batched and fused
evaluation; ``None`` means ``cuda`` and raises without a GPU. Objective
backends by name: ``"carbonpath"`` (the full Eqs. 2-17 models, batched
and fused evaluation) and ``"chipletgym"`` (the Sec VI-B baseline
assumptions, scalar host evaluation). A callable with the
``evaluate(sys, wl, db, cache=...)`` signature is also accepted.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.chipletgym import evaluate_chipletgym
from repro_torch.core.evaluate import Metrics, evaluate
from repro_torch.core.scalesim import SimCache
from repro_torch.core.system import HISystem
from repro_torch.core.techdb import DEFAULT_DB, TechDB
from repro_torch.core.templates import (
    IDENTITY_NORMALIZER,
    TEMPLATES,
    Normalizer,
    Template,
)
from repro_torch.core.workload import GEMMWorkload
from repro_torch.pathfinding.batch import (
    MetricsBatch,
    evaluate_batch,
    fit_normalizer_batched,
)
from repro_torch.pathfinding.space import DesignSpace
from repro_torch.pathfinding.strategies import (
    Objective,
    SearchResult,
    SearchStrategy,
    SimulatedAnnealing,
)
from repro_torch.runtime import trace

OBJECTIVES = {
    "carbonpath": evaluate,
    "chipletgym": evaluate_chipletgym,
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
        :mod:`repro_torch.pathfinding.device`. It only takes effect for
        the CarbonPATH backend — scalar-only backends (``chipletgym``)
        always use the host fallback, as does ``device=False``. Batched
        and fused evaluation run on ``torch_device`` (``None`` = cuda)."""
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

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, sys: HISystem) -> Metrics:
        """Scalar single-system evaluation under this objective backend."""
        return self.evaluate_fn(sys, self.wl, self.db, cache=self.cache)

    def evaluate_batch(self, encoded: np.ndarray) -> MetricsBatch:
        """Batched evaluation of an encoded population. Does not need (or
        trigger fitting of) a normalizer — metrics are raw."""
        if self.batched:
            return evaluate_batch(encoded, self.wl, self.db,
                                  space=self.space,
                                  torch_device=self.torch_device)
        obj = Objective(self.wl, self.template,
                        self._norm or IDENTITY_NORMALIZER, self.db,
                        self.evaluate_fn, self.cache, self.batched,
                        self.device, self.torch_device)
        return obj.evaluate_encoded(encoded, self.space)

    def objective(self) -> Objective:
        return Objective(self.wl, self.template, self.norm, self.db,
                         self.evaluate_fn, self.cache, self.batched,
                         self.device, self.torch_device)

    def evaluate_cost_vector(self, encoded: np.ndarray):
        """Metrics + Eq. 17 cost + ``(latency, dollar, total_cfp)``
        objective vectors for an encoded population (fused on the device
        path)."""
        return self.objective().eval_cost_vector_encoded(encoded,
                                                         self.space)

    # -- search -------------------------------------------------------------

    @trace.spanned("pf.search")
    def search(self, strategy: Optional[SearchStrategy] = None,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        """Run ``strategy`` (default: :class:`SimulatedAnnealing`)."""
        strategy = strategy or SimulatedAnnealing()
        return strategy.search(self.space, self.objective(), budget, key)

    def pareto_front(self, strategy: Optional[SearchStrategy] = None,
                     budget: Optional[int] = None,
                     key: Optional[int] = None):
        """Run a search and return its Pareto archive (see
        :mod:`repro_torch.pathfinding.pareto`). Defaults to a
        :class:`~repro_torch.pathfinding.pareto.ScalarizationSweep`."""
        if strategy is None:
            from repro_torch.pathfinding.pareto import ScalarizationSweep

            strategy = ScalarizationSweep()
        return self.search(strategy, budget, key).frontier

    def run_scenarios(self, sweep=None, workloads=None, regions=None,
                      budget: Optional[int] = None,
                      key: Optional[int] = None,
                      checkpoint_dir: Optional[str] = None,
                      resume: bool = True,
                      segment: Optional[int] = None):
        """Map frontiers across deployment regions (and optionally extra
        workloads) with this Pathfinder's template, TechDB and
        ``torch_device``: a :class:`~repro_torch.pathfinding.pareto.
        ScenarioSweep` whose whole region x workload grid runs as one
        stacked population on the device path (see
        :class:`repro_torch.pathfinding.device.ScenarioEngine`).

        ``sweep`` is a :class:`ScenarioSweep` (search knobs) or a
        :class:`~repro_torch.pathfinding.scenario.ScenarioSpec`, the
        frozen description of the whole run (workloads, regions,
        comm/schedule models, budget/segment/checkpoint knobs). With a
        spec, passing the loose ``workloads``/``regions``/``budget``/
        ``checkpoint_dir``/``segment`` kwargs as well is an error. The
        loose ``regions=`` mapping gives the same bits but is deprecated
        in favor of the spec.

        ``budget`` is the sweep's *total* evaluation budget, split evenly
        across cells. ``checkpoint_dir`` makes the sweep interruptible:
        the grid advances in ``segment``-sweep chunks and snapshots its
        carry + per-cell frontier archives at every boundary;
        ``resume=True`` (default) restores the newest snapshot and
        continues bit for bit as the uninterrupted run would. Returns a
        :class:`~repro_torch.pathfinding.pareto.ScenarioFrontier`."""
        import dataclasses
        import warnings

        from repro_torch.pathfinding.pareto import ScenarioSweep
        from repro_torch.pathfinding.scenario import ScenarioSpec

        if not self.batched:
            raise ValueError(
                "run_scenarios requires the carbonpath objective backend: "
                "ScenarioSweep rebuilds per-cell objectives from the "
                "TechDB and cannot carry a custom or chipletgym "
                "evaluate_fn")
        if isinstance(sweep, ScenarioSpec):
            if (workloads is not None or regions is not None
                    or budget is not None or checkpoint_dir is not None
                    or segment is not None):
                raise ValueError(
                    "a ScenarioSpec already carries the workloads, "
                    "regions and budget/segment/checkpoint knobs; don't "
                    "also pass them to run_scenarios()")
            return ScenarioSweep().run(
                sweep, template=self.template, db=self.db,
                device=self.device, key=key,
                torch_device=self.torch_device)
        sweep = sweep or ScenarioSweep()
        if regions is not None:
            warnings.warn(
                "run_scenarios(regions=...) is deprecated: pass a "
                "repro_torch.pathfinding.scenario.ScenarioSpec (unified "
                "workloads + {name: Region} + run knobs) as the first "
                "argument instead",
                DeprecationWarning, stacklevel=2)
            sweep = dataclasses.replace(sweep, regions=dict(regions))
        wls = [self.wl] if workloads is None else list(workloads)
        return sweep.run(wls, template=self.template, db=self.db,
                         device=self.device, budget=budget, key=key,
                         checkpoint_dir=checkpoint_dir, resume=resume,
                         segment=segment, torch_device=self.torch_device)
