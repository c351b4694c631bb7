"""Seeding of a tempering search: the random valid systems that
``ParallelTempering.search`` draws for its chains, and the neutral NoC
and schedule assignments it attaches on live mesh-NoC / window spaces.
Copied from ``repro_torch/core/sa.py``; only the imports differ."""
from __future__ import annotations

import dataclasses
import random
from typing import Tuple

from . import comm as comm_mod
from .chiplet import Chiplet
from .system import HISystem, is_valid
from .techdb import DEFAULT_DB, PKG_PROTOCOLS_25D, PKG_PROTOCOLS_3D, TechDB
from .workload import Mapping


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
    from .schedule import SCHED_NEUTRAL

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

