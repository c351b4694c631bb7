"""SA solution space + hierarchical moves (Sec V), and legacy shims.

Components: (1) the solution space = valid :class:`HISystem` vectors,
(2) hierarchical moves — application-level (mapping) vs lower-level
(chip-architecture / chiplet / package) perturbations with validity repair,
(3) the Eq. 17 cost on min/median-normalized metrics.

The annealing loop lives in
:class:`repro_torch.pathfinding.SimulatedAnnealing`; ``anneal`` below is
a thin deprecation shim over it with the seed call signature.
``fit_normalizer`` remains the scalar reference loop — prefer
:func:`repro_torch.pathfinding.fit_normalizer_batched` for large
populations.

Runtime mitigations from Sec V-D are both present: the ScaleSim-equivalent
simulation cache (shared across the whole anneal — node-only chiplet moves
hit the cache because cycle count is node-independent) and incremental
re-evaluation falls out of the same property.

Schedule (Sec VI-A): T0 = 4000, Tf = 0.001, cooling 0.99, 50 moves/temp.
"""
from __future__ import annotations

import dataclasses
import random
import warnings
from typing import Callable, List, Optional, Tuple

from repro_torch.core import comm as comm_mod
from repro_torch.core.chiplet import Chiplet
from repro_torch.core.evaluate import Metrics, evaluate
from repro_torch.core.scalesim import SimCache
from repro_torch.core.system import HISystem, is_valid, style_for_count
from repro_torch.core.techdb import (
    DEFAULT_DB,
    PKG_PROTOCOLS_25D,
    PKG_PROTOCOLS_3D,
    TechDB,
)
from repro_torch.core.templates import Normalizer, Template
from repro_torch.core.workload import GEMMWorkload, Mapping


@dataclasses.dataclass
class SAConfig:
    t_initial: float = 4000.0
    t_final: float = 0.001
    cooling: float = 0.99
    moves_per_temp: int = 50
    max_chiplets: int = 6
    norm_samples: int = 10_000
    seed: int = 0


@dataclasses.dataclass
class SAResult:
    best: HISystem
    best_metrics: Metrics
    best_cost: float
    history: List[float]
    evaluations: int
    cache: SimCache


# ---------------------------------------------------------------------------
# Multi-objective cost vector (the Fig. 13 / Pareto axes)
# ---------------------------------------------------------------------------

# The three trade-off axes the paper's frontier figures plot: performance
# (latency), system cost (dollars) and carbon footprint (embodied +
# operational). Every scalarized Eq. 17 cost collapses these; the Pareto
# machinery in :mod:`repro_torch.pathfinding.pareto` keeps them separate.
OBJECTIVE_AXES: Tuple[str, str, str] = ("latency_s", "dollar", "total_cfp")


def cost_vector(m: Metrics) -> Tuple[float, float, float]:
    """Per-axis ``(latency_s, dollar, total_cfp)`` objective vector.

    The scalar reference for the batched/device renderings
    (:meth:`repro_torch.pathfinding.Objective.cost_vector_batch` and the fused
    jit program in :mod:`repro_torch.pathfinding.device`): all three must agree
    within 1e-6 relative. All axes are *minimized*; unlike the Eq. 17
    scalar cost the vector is unnormalized (raw metric units), so
    frontiers are comparable across normalizers and templates."""
    return (m.latency_s, m.dollar, m.total_cfp)


# ---------------------------------------------------------------------------
# Random valid system generation
# ---------------------------------------------------------------------------


def random_chiplet(rng: random.Random, db: TechDB) -> Chiplet:
    a = rng.choice(db.array_sizes)
    t = rng.choice(db.tech_nodes)
    s = rng.choice(db.sram_sizes_kb[a])
    return Chiplet(a, t, s)


def random_mapping(rng: random.Random) -> Mapping:
    return Mapping(rng.choice((0, 1)), rng.choice(("OS", "WS", "IS")),
                   rng.choice((0, 1)))


def _pick_25d(rng: random.Random) -> Tuple[str, str]:
    pkg = rng.choice(list(PKG_PROTOCOLS_25D))
    return pkg, rng.choice(PKG_PROTOCOLS_25D[pkg])


def _pick_3d(rng: random.Random) -> Tuple[str, str]:
    pkg = rng.choice(list(PKG_PROTOCOLS_3D))
    return pkg, rng.choice(PKG_PROTOCOLS_3D[pkg])


def _style_fields(style: str, n: int, rng: random.Random):
    """pkg/proto/stack fields consistent with a style and chiplet count."""
    pkg25 = proto25 = pkg3 = proto3 = None
    stack: Tuple[int, ...] = ()
    if style in ("2.5D", "2.5D+3D"):
        pkg25, proto25 = _pick_25d(rng)
    if style in ("3D", "2.5D+3D"):
        pkg3, proto3 = _pick_3d(rng)
    if style == "2.5D+3D":
        size = rng.randint(2, n - 1)
        stack = tuple(sorted(rng.sample(range(n), size)))
    return pkg25, proto25, pkg3, proto3, stack


def random_system(rng: random.Random, db: TechDB = DEFAULT_DB,
                  max_chiplets: int = 6) -> HISystem:
    """Random but *valid* HI system (SA initialization, Sec V-A)."""
    while True:
        n = rng.randint(1, max_chiplets)
        if n == 1:
            style = "2D"
        elif n == 2:
            style = rng.choice(("2.5D", "3D"))
        else:
            style = rng.choice(("2.5D", "3D", "2.5D+3D"))
        pkg25, proto25, pkg3, proto3, stack = _style_fields(style, n, rng)
        sys = HISystem(
            chiplets=tuple(random_chiplet(rng, db) for _ in range(n)),
            style=style,
            memory=rng.choice(list(db.memories)),
            mapping=random_mapping(rng),
            pkg_25d=pkg25, proto_25d=proto25,
            pkg_3d=pkg3, proto_3d=proto3,
            stack=stack,
        )
        if is_valid(sys, db, max_chiplets):
            return sys


# ---------------------------------------------------------------------------
# Hierarchical moves (Sec V-B)
# ---------------------------------------------------------------------------


def _move_application(sys: HISystem, rng: random.Random, db: TechDB) -> HISystem:
    m = sys.mapping
    which = rng.randrange(3)
    if which == 0:    # dataflow
        m = Mapping(m.order,
                    rng.choice([d for d in ("OS", "WS", "IS")
                                if d != m.dataflow]), m.split_k)
    elif which == 1:  # split-K toggle
        m = Mapping(m.order, m.dataflow, 1 - m.split_k)
    else:             # assigning order toggle
        m = Mapping(1 - m.order, m.dataflow, m.split_k)
    return dataclasses.replace(sys, mapping=m)


def _repair_style(sys: HISystem, rng: random.Random, db: TechDB) -> HISystem:
    """Dynamic HI-type adjustment + field repair after a count change."""
    n = sys.n_chiplets
    style = style_for_count(n, sys.style)
    pkg25, proto25 = sys.pkg_25d, sys.proto_25d
    pkg3, proto3 = sys.pkg_3d, sys.proto_3d
    stack = sys.stack
    if style in ("2.5D", "2.5D+3D") and not pkg25:
        pkg25, proto25 = _pick_25d(rng)
    if style in ("3D", "2.5D+3D") and not pkg3:
        pkg3, proto3 = _pick_3d(rng)
    if style != "2.5D+3D":
        stack = ()
    else:
        stack = tuple(i for i in stack if i < n)
        if len(stack) < 2 or len(stack) >= n:
            size = rng.randint(2, n - 1)
            stack = tuple(sorted(rng.sample(range(n), size)))
    if style == "2D":
        pkg25 = proto25 = pkg3 = proto3 = None
    if style == "2.5D":
        pkg3 = proto3 = None
    if style == "3D":
        pkg25 = proto25 = None
    return dataclasses.replace(
        sys, style=style, pkg_25d=pkg25, proto_25d=proto25,
        pkg_3d=pkg3, proto_3d=proto3, stack=stack)


def _move_chip_arch(sys: HISystem, rng: random.Random, db: TechDB,
                    max_chiplets: int) -> HISystem:
    if rng.random() < 0.5:   # grow/shrink chiplet count
        n = sys.n_chiplets
        delta = rng.choice((-1, 1))
        n2 = min(max(n + delta, 1), max_chiplets)
        if n2 == n:
            n2 = min(max(n - delta, 1), max_chiplets)
        chips = list(sys.chiplets)
        noc = list(sys.noc)
        if n2 > n:
            chips.append(random_chiplet(rng, db))
            if noc:   # new chiplet starts at the neutral single-tile mesh
                noc.append(comm_mod.NOC_NEUTRAL)
        else:
            idx = rng.randrange(len(chips))
            chips.pop(idx)
            if noc:
                noc.pop(idx)
        sys = dataclasses.replace(sys, chiplets=tuple(chips),
                                  noc=tuple(noc))
        return _repair_style(sys, rng, db)
    # memory-type move
    mem = rng.choice([m for m in db.memories if m != sys.memory])
    return dataclasses.replace(sys, memory=mem)


def _move_chiplet(sys: HISystem, rng: random.Random, db: TechDB) -> HISystem:
    idx = rng.randrange(sys.n_chiplets)
    chips = list(sys.chiplets)
    new = random_chiplet(rng, db)
    while new == chips[idx]:
        new = random_chiplet(rng, db)
    chips[idx] = new
    return dataclasses.replace(sys, chiplets=tuple(chips))


def _move_noc(sys: HISystem, rng: random.Random, db: TechDB) -> HISystem:
    """mesh_noc comm-model move: re-draw one chiplet's (mesh dims, entry
    placement) pair uniformly, excluding the current assignment."""
    idx = rng.randrange(sys.n_chiplets)
    cur = sys.noc[idx]
    while True:
        cand = (rng.randrange(len(comm_mod.MESH_DIMS)),
                rng.randrange(len(comm_mod.ENTRY_PLACEMENTS)))
        if cand != cur:
            break
    noc = list(sys.noc)
    noc[idx] = cand
    return dataclasses.replace(sys, noc=tuple(noc))


def _move_schedule(sys: HISystem, rng: random.Random,
                   db: TechDB) -> HISystem:
    """window schedule-model move: shift the start hour or re-draw the
    duty-window shape, excluding the current value (rejection-free —
    the offset draw can never land on the current assignment)."""
    from repro_torch.core import schedule as sched_mod

    start, shape = sys.schedule
    if rng.randrange(2) == 0:
        start = (start + 1 + rng.randrange(
            sched_mod.HOURS_PER_DAY - 1)) % sched_mod.HOURS_PER_DAY
    else:
        n = sched_mod.n_schedule_shapes()
        shape = (shape + 1 + rng.randrange(n - 1)) % n
    return dataclasses.replace(sys, schedule=(start, shape))


def seed_schedule(sys: HISystem) -> HISystem:
    """Attach the neutral (0, 0) schedule to a fixed-schedule system.

    The temporal twin of :func:`seed_noc`: strategies searching a *live*
    window :class:`~repro_torch.pathfinding.DesignSpace` call this on their
    random seeds before proposing — ``random_system`` draws no schedule
    axes (keeping its RNG stream legacy-identical) and :func:`propose`
    only fires schedule moves on systems that carry one. Neutral (start
    0, shape 0) decodes to ``db.load_profile`` itself, so the seeded
    system evaluates bit-identically. No RNG draws."""
    if sys.schedule is not None:
        return sys
    from repro_torch.core.schedule import SCHED_NEUTRAL

    return dataclasses.replace(sys, schedule=SCHED_NEUTRAL)


def seed_noc(sys: HISystem) -> HISystem:
    """Attach the neutral per-chiplet NoC assignment to a legacy system.

    Strategies searching a *live* mesh_noc space call this on their
    random seeds before proposing: ``random_system`` draws no NoC axes
    (keeping its RNG stream legacy-identical), and :func:`propose` only
    fires NoC moves on systems that carry them. Neutral = (1x1 mesh,
    corner entry) per chiplet — zero mesh hops, one router — so the
    seeded system evaluates bit-identically to its legacy self. No RNG
    draws."""
    if sys.noc:
        return sys
    return dataclasses.replace(
        sys, noc=(comm_mod.NOC_NEUTRAL,) * sys.n_chiplets)


def _move_package(sys: HISystem, rng: random.Random, db: TechDB) -> HISystem:
    if sys.style == "2D":
        return sys
    options = []
    if sys.style in ("2.5D", "2.5D+3D"):
        options += ["pkg25", "proto25"]
    if sys.style in ("3D", "2.5D+3D"):
        options += ["pkg3"]
    which = rng.choice(options)
    if which == "pkg25":
        pkg = rng.choice([p for p in PKG_PROTOCOLS_25D if p != sys.pkg_25d])
        proto = (sys.proto_25d if sys.proto_25d in PKG_PROTOCOLS_25D[pkg]
                 else rng.choice(PKG_PROTOCOLS_25D[pkg]))
        return dataclasses.replace(sys, pkg_25d=pkg, proto_25d=proto)
    if which == "proto25":
        protos = [p for p in PKG_PROTOCOLS_25D[sys.pkg_25d]
                  if p != sys.proto_25d]
        if not protos:
            return sys
        return dataclasses.replace(sys, proto_25d=rng.choice(protos))
    pkg = rng.choice([p for p in PKG_PROTOCOLS_3D if p != sys.pkg_3d])
    return dataclasses.replace(sys, pkg_3d=pkg, proto_3d="UCIe-3D")


def propose(sys: HISystem, rng: random.Random, db: TechDB = DEFAULT_DB,
            max_chiplets: int = 6, p_application: float = 0.35,
            noc_moves: bool = False,
            schedule_moves: bool = False) -> HISystem:
    """Hierarchical move selection: application level first, then one of
    the lower levels; repair + validity check, retry until valid.

    ``noc_moves=True`` (set by strategies searching a *live* mesh_noc
    :class:`~repro_torch.pathfinding.DesignSpace`) adds the NoC axes as a
    fourth lower level; ``schedule_moves=True`` (live window schedule
    spaces) adds the temporal axis as the next one. The defaults consume
    the exact legacy RNG stream, so legacy and frozen-neutral searches
    are bit-identical."""
    noc_on = bool(noc_moves and sys.noc)
    sched_on = bool(schedule_moves and sys.schedule is not None)
    n_levels = 3 + noc_on + sched_on
    for _ in range(64):
        if rng.random() < p_application:
            cand = _move_application(sys, rng, db)
        else:
            level = rng.randrange(n_levels)
            if level == 0:
                cand = _move_chip_arch(sys, rng, db, max_chiplets)
            elif level == 1:
                cand = _move_chiplet(sys, rng, db)
            elif level == 2:
                cand = _move_package(sys, rng, db)
            elif level == 3 and noc_on:
                cand = _move_noc(sys, rng, db)
            else:
                cand = _move_schedule(sys, rng, db)
        if is_valid(cand, db, max_chiplets):
            return cand
    return sys


# ---------------------------------------------------------------------------
# Normalizer fitting (scalar reference loop)
# ---------------------------------------------------------------------------


def fit_normalizer(
    wl: GEMMWorkload,
    db: TechDB = DEFAULT_DB,
    samples: int = 10_000,
    seed: int = 1234,
    cache: Optional[SimCache] = None,
    evaluate_fn: Callable[..., Metrics] = evaluate,
    max_chiplets: int = 6,
) -> Normalizer:
    """Sample random valid systems and fit the min/median normalizer."""
    rng = random.Random(seed)
    cache = cache if cache is not None else SimCache()
    pop = []
    for _ in range(samples):
        s = random_system(rng, db, max_chiplets)
        pop.append(evaluate_fn(s, wl, db, cache=cache))
    return Normalizer.fit(pop)


def anneal(
    wl: GEMMWorkload,
    template: Template,
    db: TechDB = DEFAULT_DB,
    config: Optional[SAConfig] = None,
    norm: Optional[Normalizer] = None,
    cache: Optional[SimCache] = None,
    evaluate_fn: Callable[..., Metrics] = evaluate,
    initial: Optional[HISystem] = None,
    torch_device=None,
) -> SAResult:
    """Deprecation shim over the Pathfinder API.

    The annealing engine lives in
    :class:`repro_torch.pathfinding.SimulatedAnnealing`; this wrapper
    keeps the seed call signature and, for a given normalizer, produces
    the same trajectory (same RNG stream, same moves, same evaluations).
    With ``norm=None`` the normalizer is fitted by :func:`fit_normalizer`
    on ``min(config.norm_samples, 2000)`` systems. ``torch_device`` is
    the :class:`~repro_torch.pathfinding.Pathfinder`'s (``None`` = cuda);
    the annealing itself is scalar host code. Migrate to::

        Pathfinder(wl, template, db=db, norm=norm).search(
            strategy=SimulatedAnnealing(config))
    """
    warnings.warn(
        "repro_torch.core.sa.anneal is deprecated; use repro_torch."
        "pathfinding.Pathfinder with the SimulatedAnnealing strategy",
        DeprecationWarning, stacklevel=2)
    from repro_torch.pathfinding import Pathfinder, SimulatedAnnealing

    cfg = config or SAConfig()
    cache = cache if cache is not None else SimCache()
    if norm is None:
        norm = fit_normalizer(wl, db, min(cfg.norm_samples, 2000),
                              cfg.seed + 1, cache, evaluate_fn,
                              cfg.max_chiplets)
    pf = Pathfinder(wl, template, db=db, objective=evaluate_fn, norm=norm,
                    cache=cache, max_chiplets=cfg.max_chiplets,
                    torch_device=torch_device)
    # SAResult has no frontier field, so collecting one here would be
    # pure per-move overhead
    res = pf.search(strategy=SimulatedAnnealing(cfg, initial=initial,
                                                frontier_size=0))
    return SAResult(res.best, res.best_metrics, res.best_cost, res.history,
                    res.evaluations, cache)
