"""Search strategies over the encoded HI design space (torch port).

Every strategy implements the :class:`SearchStrategy` protocol::

    search(space, objective, budget, key) -> SearchResult

where ``space`` is a :class:`~repro_torch.pathfinding.space.DesignSpace`,
``objective`` bundles the workload / cost template / normalizer and the
evaluation device, ``budget`` caps the number of evaluations (None =
strategy default schedule) and ``key`` seeds the strategy's RNG.

Strategies:

* :class:`SimulatedAnnealing` — the paper's hierarchical-move annealer
  (Sec V): scalar host code, ``random.Random`` and per-move evaluation
  through the shared SimCache, trajectory-equal to the reference's for
  equal seeds/config.
* :class:`ParallelTempering` — N concurrent chains on a geometric
  temperature ladder with replica exchange, on the torch device engine
  (:mod:`repro_torch.pathfinding.device`) or on the host path through
  the batched evaluator.
* :class:`RandomSearch` — batched uniform sampling of valid systems.
* :class:`GridSweep` — deterministic sweep of package x protocol x
  memory x mapping for a fixed chiplet multiset (the Sec V-A 43-combo
  enumeration).

On a device-capable objective the batched strategies evaluate through
the fused evaluator on ``Objective.torch_device``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core.chiplet import Chiplet, different_chiplet_system
from repro_torch.core.evaluate import Metrics, evaluate
from repro_torch.core.sa import SAConfig
from repro_torch.core.scalesim import SimCache
from repro_torch.core.system import HISystem
from repro_torch.core.techdb import (
    DEFAULT_DB,
    TechDB,
    valid_pairs_25d,
    valid_pairs_3d,
)
from repro_torch.core.templates import (
    METRIC_FIELDS,
    Normalizer,
    Template,
    sa_cost,
)
from repro_torch.core.workload import ALL_MAPPINGS, GEMMWorkload
from repro_torch.pathfinding.batch import MetricsBatch, evaluate_batch
from repro_torch.pathfinding.space import DesignSpace
from repro_torch.runtime import trace


@dataclasses.dataclass
class SearchResult:
    """What every strategy returns.

    ``frontier`` is the Pareto archive of every design the strategy
    evaluated, over the :data:`repro_torch.core.sa.OBJECTIVE_AXES` axes
    ``(latency_s, dollar, total_cfp)`` — ``None`` only when collection
    was disabled (``frontier_size=0``)."""

    best: HISystem
    best_metrics: Metrics
    best_cost: float
    history: List[float]
    evaluations: int
    cache: Optional[SimCache] = None
    frontier: Optional["object"] = None   # ParetoArchive

    def __repr__(self) -> str:
        front = "none" if self.frontier is None else len(self.frontier)
        return (f"SearchResult(best_cost={self.best_cost:.6g}, "
                f"evaluations={self.evaluations}, "
                f"history={len(self.history)} pts, frontier={front})")


@dataclasses.dataclass
class Objective:
    """Workload + Eq. 17 cost + evaluation backend, scalar and batched.

    ``torch_device`` is where batched and fused evaluation run (``None``
    = cuda); the scalar ``evaluate_fn`` runs on the host."""

    wl: GEMMWorkload
    template: Template
    norm: Normalizer
    # TechDB is unhashable, so it cannot be a plain field default
    db: TechDB = dataclasses.field(default_factory=lambda: DEFAULT_DB)
    evaluate_fn: object = evaluate          # scalar backend
    cache: SimCache = dataclasses.field(default_factory=SimCache)
    # None -> derived: only the CarbonPATH scalar reference has a
    # parity-guaranteed batched twin
    batched: Optional[bool] = None
    # None -> follows ``batched``: the fused device evaluator is the
    # same CarbonPATH math
    device: Optional[bool] = None
    torch_device: DeviceLike = None

    def __post_init__(self):
        if self.batched is None:
            self.batched = self.evaluate_fn is evaluate
        if self.device is None:
            self.device = self.batched
        self.device = self.device and self.batched
        mins, medians = self.norm.weights_arrays()
        self._cost_mins = mins
        self._cost_medians = medians
        self._cost_w = np.asarray(self.template.weights, dtype=np.float64)

    def evaluate(self, sys: HISystem) -> Metrics:
        return self.evaluate_fn(sys, self.wl, self.db, cache=self.cache)

    def cost(self, m: Metrics) -> float:
        return sa_cost(m, self.template, self.norm)

    # -- multi-objective vector (OBJECTIVE_AXES order) ----------------------

    def cost_vector(self, m: Metrics) -> np.ndarray:
        """Scalar-path ``(latency_s, dollar, total_cfp)`` vector."""
        from repro_torch.core.sa import cost_vector

        return np.asarray(cost_vector(m), dtype=np.float64)

    def cost_vector_batch(self, mb: MetricsBatch) -> np.ndarray:
        """``[P, 3]`` objective vectors for a batch (raw metric units)."""
        return mb.objective_vectors()

    def _device_evaluator(self, space: DesignSpace):
        from repro_torch.pathfinding.device import get_device_evaluator

        return get_device_evaluator(self.wl, self.db, space=space,
                                    torch_device=self.torch_device)

    def eval_cost_vector_encoded(self, encoded: np.ndarray,
                                 space: DesignSpace
                                 ) -> Tuple[MetricsBatch, np.ndarray,
                                            np.ndarray]:
        """Metrics + Eq. 17 cost + objective vectors in one call; on the
        device path all three come out of the same fused evaluation."""
        if self.device:
            return self._device_evaluator(space).evaluate_cost_vector(
                encoded, self.norm, self.template)
        mb = self.evaluate_encoded(encoded, space)
        return mb, self.cost_batch(mb), self.cost_vector_batch(mb)

    def evaluate_encoded(self, encoded: np.ndarray,
                         space: DesignSpace) -> MetricsBatch:
        if self.batched:
            return evaluate_batch(encoded, self.wl, self.db, space=space,
                                  torch_device=self.torch_device)
        # non-vectorized backends fall back to the scalar model per row
        # but keep the struct-of-arrays interface
        ms = [self.evaluate(s) for s in space.decode_many(encoded)]
        return MetricsBatch(**{
            f.name: np.array([getattr(m, f.name) for m in ms])
            for f in dataclasses.fields(MetricsBatch)})

    def eval_cost_encoded(self, encoded: np.ndarray, space: DesignSpace
                          ) -> Tuple[MetricsBatch, np.ndarray]:
        """Metrics + Eq. 17 cost in one call (one fused evaluation on the
        device path)."""
        if self.device:
            return self._device_evaluator(space).evaluate_cost(
                encoded, self.norm, self.template)
        mb = self.evaluate_encoded(encoded, space)
        return mb, self.cost_batch(mb)

    def cost_batch(self, mb: MetricsBatch) -> np.ndarray:
        x = np.stack([mb.fields()[f] for f in METRIC_FIELDS], axis=1)
        return ((x - self._cost_mins) / self._cost_medians
                * self._cost_w).sum(axis=1)


class SearchStrategy(Protocol):
    def search(self, space: DesignSpace, objective: Objective,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        ...


# ``key=None`` resolves to this fixed default instead of 0, so ``key=0``
# is a distinct seed (the 32-bit golden-ratio mix constant)
DEFAULT_SEARCH_KEY = 0x9E3779B9


def _resolve_key(key: Optional[int]) -> int:
    return DEFAULT_SEARCH_KEY if key is None else key


def _check_budget(budget: Optional[int]) -> None:
    """``budget`` is None (strategy default schedule) or a positive
    integer evaluation cap."""
    if budget is None:
        return
    if isinstance(budget, bool) or not isinstance(budget, (int, np.integer)):
        raise TypeError(
            f"budget must be an int or None, got {type(budget).__name__}")
    if budget < 1:
        raise ValueError(f"budget must be >= 1 or None, got {budget}")


def budget_sweeps(sweeps: int, population: int,
                  budget: Optional[int], *, detail: str = "") -> int:
    """Clamp a sweep count to a *total* evaluation budget.

    One chain population costs ``population`` evaluations to seed and
    ``population`` more per sweep, so ``budget`` evaluations pay for at
    most ``(budget - population) // population`` whole sweeps. A budget
    below one population cannot seed the chains and is rejected
    (``detail`` extends the message). :class:`ParallelTempering` keeps
    its own accounting (truncation instead of a reject)."""
    if budget is None:
        return sweeps
    if budget < population:
        raise ValueError(
            f"budget {budget} < one chain population {population}{detail}")
    return min(sweeps, (budget - population) // population)


def _checkpointer(checkpoint_dir: Optional[str]):
    """A :class:`~repro_torch.pathfinding.resume.SearchCheckpointer` for
    the directory, or ``None`` when checkpointing is off."""
    if checkpoint_dir is None:
        return None
    from repro_torch.pathfinding.resume import SearchCheckpointer

    return SearchCheckpointer(checkpoint_dir)


def _check_checkpointable(checkpoint_dir: Optional[str],
                          objective: "Objective") -> None:
    """Checkpoint/resume lives in the segmented device engines; the host
    fallbacks have no snapshot-able carry, so asking for both is a
    configuration error."""
    if checkpoint_dir is not None and not objective.device:
        raise ValueError(
            "checkpoint_dir requires the device engine "
            "(Pathfinder(device=True) with the carbonpath backend); the "
            "scalar host fallback cannot checkpoint")


# ---------------------------------------------------------------------------
# Simulated annealing (Sec V)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimulatedAnnealing:
    """The paper's SA engine: for a given config/seed it follows the
    reference's trajectory exactly (same RNG stream, same moves, same
    scalar evaluations through the shared SimCache). It is host code on
    every objective.

    Unlike the other strategies, ``key=None`` defers to ``config.seed``
    rather than :data:`DEFAULT_SEARCH_KEY`."""

    config: Optional[SAConfig] = None
    initial: Optional[HISystem] = None
    frontier_size: int = 256

    def search(self, space: DesignSpace, objective: Objective,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        from repro_torch.core.sa import (
            propose,
            random_system,
            seed_noc,
            seed_schedule,
        )
        from repro_torch.pathfinding.pareto import FrontierFeed

        _check_budget(budget)
        cfg = self.config or SAConfig(max_chiplets=space.max_chiplets)
        db = objective.db
        rng = random.Random(cfg.seed if key is None else key)
        feed = FrontierFeed(self.frontier_size)
        collect = feed.archive is not None

        cur = self.initial or random_system(rng, db, cfg.max_chiplets)
        if space.noc_live:
            cur = seed_noc(cur)
        if space.sched_live:
            cur = seed_schedule(cur)
        cur_m = objective.evaluate(cur)
        cur_c = objective.cost(cur_m)
        if collect:
            feed.add(space.encode(cur), objective.cost_vector(cur_m))
        best, best_m, best_c = cur, cur_m, cur_c
        history = [cur_c]
        evals = 1

        t = cfg.t_initial
        while t > cfg.t_final:
            for _ in range(cfg.moves_per_temp):
                if budget is not None and evals >= budget:
                    break
                cand = propose(cur, rng, db, cfg.max_chiplets,
                               noc_moves=space.noc_live,
                               schedule_moves=space.sched_live)
                if cand is cur:      # no valid move found: not evaluated
                    continue
                m = objective.evaluate(cand)
                c = objective.cost(m)
                evals += 1
                if collect:
                    feed.add(space.encode(cand), objective.cost_vector(m))
                delta = c - cur_c
                if delta <= 0 or rng.random() < math.exp(
                        -delta / max(t, 1e-12)):
                    cur, cur_m, cur_c = cand, m, c
                    if c < best_c:
                        best, best_m, best_c = cand, m, c
            history.append(cur_c)
            t *= cfg.cooling
            if budget is not None and evals >= budget:
                break
        return SearchResult(best, best_m, best_c, history, evals,
                            objective.cache, frontier=feed.done())


# ---------------------------------------------------------------------------
# Parallel tempering: batched chains + replica exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParallelTempering:
    """N simultaneous SA chains on a geometric temperature ladder. Every
    sweep proposes one hierarchical move per chain and evaluates all
    candidates in one batched call; every ``swap_every`` sweeps
    adjacent-temperature replicas attempt a Metropolis exchange.

    With a device-capable objective (``Pathfinder(device=True)``, the
    default) the whole sweep loop — propose, evaluate, Metropolis
    accept, replica exchange — runs on the torch device engine
    (:mod:`repro_torch.pathfinding.device`), advanced in segments of
    ``segment`` sweeps (default: one segment). Segmentation never
    changes the trajectory, but gives the search its checkpoint
    boundaries: with ``checkpoint_dir`` set, the carry + frontier archive
    + history snapshot atomically at every boundary
    (:mod:`repro_torch.pathfinding.resume`), and ``resume=True``
    (default) restores the newest snapshot, so an interrupted search
    reproduces the uninterrupted run bit for bit. The host path below is
    kept as the fallback (checkpointing needs the device engine)."""

    n_chains: int = 8
    t_max: float = 4000.0
    t_min: float = 1.0
    sweeps: int = 500
    swap_every: int = 5
    frontier_size: int = 256
    segment: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = True

    def search(self, space: DesignSpace, objective: Objective,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        from repro_torch.core.sa import propose, random_system
        from repro_torch.pathfinding.pareto import FrontierFeed

        _check_budget(budget)
        _check_checkpointable(self.checkpoint_dir, objective)
        key = _resolve_key(key)
        db = objective.db
        rng = random.Random(key)
        # the initial population costs one evaluation per chain, so a
        # tiny budget bounds the ladder width itself
        n = self.n_chains if budget is None else min(self.n_chains, budget)
        ratio = (self.t_min / self.t_max) ** (1.0 / max(1, n - 1))
        temps = [self.t_max * ratio ** i for i in range(n)]

        with trace.span("pf.seed"):
            chains = [random_system(rng, db, space.max_chiplets)
                      for _ in range(n)]
            if space.noc_live:
                from repro_torch.core.sa import seed_noc

                chains = [seed_noc(s) for s in chains]
            if space.sched_live:
                from repro_torch.core.sa import seed_schedule

                chains = [seed_schedule(s) for s in chains]
            enc0 = space.encode_many(chains)
        if objective.device:
            return self._search_device(space, objective, budget, key,
                                       enc0, temps)
        feed = FrontierFeed(self.frontier_size)
        mb = objective.evaluate_encoded(enc0, space)
        costs = objective.cost_batch(mb).tolist()
        feed.add(enc0, objective.cost_vector_batch(mb))
        evals = n
        bi = int(np.argmin(costs))
        best, best_m, best_c = chains[bi], mb.row(bi), costs[bi]
        history = [best_c]

        for sweep in range(self.sweeps):
            # honor the budget exactly: a final partial sweep evaluates
            # only as many chains as evaluations remain
            k = n if budget is None else min(n, budget - evals)
            if k <= 0:
                break
            cands = [propose(chains[i], rng, db, space.max_chiplets,
                             noc_moves=space.noc_live,
                             schedule_moves=space.sched_live)
                     for i in range(k)]
            enc = space.encode_many(cands)
            mb = objective.evaluate_encoded(enc, space)
            ccosts = objective.cost_batch(mb).tolist()
            feed.add(enc, objective.cost_vector_batch(mb))
            evals += k
            for i in range(k):
                delta = ccosts[i] - costs[i]
                if delta <= 0 or rng.random() < math.exp(
                        -delta / max(temps[i], 1e-12)):
                    chains[i], costs[i] = cands[i], ccosts[i]
                    if ccosts[i] < best_c:
                        best, best_m, best_c = cands[i], mb.row(i), ccosts[i]
            if sweep % self.swap_every == 0:
                _replica_exchange(temps, chains, costs, rng)
            history.append(costs[-1])  # coldest chain
        return SearchResult(best, best_m, best_c, history, evals,
                            objective.cache, frontier=feed.done())

    def _search_device(self, space: DesignSpace, objective: Objective,
                       budget: Optional[int], key: int,
                       enc0: np.ndarray, temps) -> SearchResult:
        """The device-engine path. Proposals come from the device move
        generator (same hierarchical distribution, threefry stream), so
        trajectories are deterministic per key and equal the reference's
        device trajectories; with a budget, only whole sweeps run. The
        winner's Metrics come from one scalar evaluation of an
        already-searched row (outside the budget accounting)."""
        from repro_torch.pathfinding.pareto import ParetoArchive

        n = len(enc0)
        dev = objective._device_evaluator(space)
        sweeps = self.sweeps
        if budget is not None:
            sweeps = min(sweeps, max(0, budget - n) // n)
        archive = (ParetoArchive(max_size=self.frontier_size)
                   if self.frontier_size > 0 else None)
        res = dev.parallel_tempering(
            enc0, np.asarray(temps), sweeps,
            self.swap_every, seed=key,
            norm=objective.norm, template=objective.template,
            collect_samples=self.frontier_size > 0,
            segment=self.segment, archive=archive,
            checkpoint=_checkpointer(self.checkpoint_dir),
            resume=self.resume)
        with trace.span("pf.best"):
            best = space.decode(res.best_enc)
            best_m = objective.evaluate(best)
        return SearchResult(best, best_m, res.best_cost, res.history,
                            res.evaluations, objective.cache,
                            frontier=archive)


def _replica_exchange(temps: Sequence[float], chains: list, costs: list,
                      rng: random.Random) -> None:
    """Metropolis swap between adjacent replicas (detailed balance):
    accept with min(1, exp[(beta_i - beta_j)(E_i - E_j)])."""
    for i in range(len(temps) - 1):
        d = ((1.0 / temps[i] - 1.0 / temps[i + 1])
             * (costs[i] - costs[i + 1]))
        if d >= 0 or rng.random() < math.exp(d):
            chains[i], chains[i + 1] = chains[i + 1], chains[i]
            costs[i], costs[i + 1] = costs[i + 1], costs[i]


# ---------------------------------------------------------------------------
# Random search + grid sweep (batched baselines)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RandomSearch:
    """Uniform sampling of valid systems, evaluated in batches."""

    batch_size: int = 512
    frontier_size: int = 256

    def search(self, space: DesignSpace, objective: Objective,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        from repro_torch.pathfinding.pareto import FrontierFeed

        _check_budget(budget)
        budget = budget if budget is not None else 2048
        # one Generator across batches: each batch continues the stream
        rng = np.random.default_rng(_resolve_key(key))
        feed = FrontierFeed(self.frontier_size)
        best = best_m = None
        best_c = math.inf
        history: List[float] = []
        evals = 0
        while evals < budget:
            k = min(self.batch_size, budget - evals)
            enc = space.sample(k, key=rng)
            mb, costs, vec = objective.eval_cost_vector_encoded(enc, space)
            feed.add(enc, vec)
            evals += k
            i = int(np.argmin(costs))
            if costs[i] < best_c:
                best, best_m, best_c = (space.decode(enc[i]), mb.row(i),
                                        float(costs[i]))
            history.append(best_c)
        return SearchResult(best, best_m, best_c, history, evals,
                            objective.cache, frontier=feed.done())


@dataclasses.dataclass
class GridSweep:
    """Deterministic sweep: every package-protocol combination (the
    paper's 10 + 3 + 30 = 43, Sec V-A) x memory x mapping for a fixed
    chiplet multiset, evaluated in one batch. Hybrid combos stack the
    ``stack`` indices."""

    chiplets: Optional[Tuple[Chiplet, ...]] = None
    memories: Optional[Sequence[str]] = None
    mappings: Sequence = ALL_MAPPINGS
    stack: Tuple[int, ...] = (1, 2)
    frontier_size: int = 256

    def systems(self, db: TechDB) -> List[HISystem]:
        chips = tuple(self.chiplets or different_chiplet_system())
        mems = list(self.memories or db.memories)
        out = []
        for mem in mems:
            for mapping in self.mappings:
                for pkg, proto in valid_pairs_25d():
                    out.append(HISystem(chips, "2.5D", mem, mapping,
                                        pkg_25d=pkg, proto_25d=proto))
                for pkg, proto in valid_pairs_3d():
                    out.append(HISystem(chips, "3D", mem, mapping,
                                        pkg_3d=pkg, proto_3d=proto))
                for p25, pr25 in valid_pairs_25d():
                    for p3, pr3 in valid_pairs_3d():
                        out.append(HISystem(
                            chips, "2.5D+3D", mem, mapping, pkg_25d=p25,
                            proto_25d=pr25, pkg_3d=p3, proto_3d=pr3,
                            stack=self.stack))
        return out

    def search(self, space: DesignSpace, objective: Objective,
               budget: Optional[int] = None,
               key: Optional[int] = None) -> SearchResult:
        from repro_torch.pathfinding.pareto import FrontierFeed

        _check_budget(budget)
        systems = self.systems(objective.db)
        if budget is not None:
            systems = systems[:budget]
        enc = space.encode_many(systems)
        mb, costs, vec = objective.eval_cost_vector_encoded(enc, space)
        feed = FrontierFeed(self.frontier_size)
        feed.add(enc, vec)
        i = int(np.argmin(costs))
        running = np.minimum.accumulate(costs)
        return SearchResult(systems[i], mb.row(i), float(costs[i]),
                            running.tolist(), len(systems), objective.cache,
                            frontier=feed.done())
