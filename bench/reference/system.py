"""HI-system configuration vector + feasibility rules (Sec V-A).

An :class:`HISystem` is one candidate solution of the search engine: the
chiplet multiset, integration style, package interconnect(s), protocol(s),
system memory, and the workload mapping triple. ``validate`` enforces the
paper's feasibility rules; every SA move goes through it.

For population-scale work, systems have a canonical fixed-width ``int32``
encoding — see :class:`repro_torch.pathfinding.DesignSpace`, whose
``validity_mask`` is the vectorized rendering of :func:`validate` and
whose ``encode``/``decode`` round-trip exactly over valid systems.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .chiplet import Chiplet
from .techdb import (
    DEFAULT_DB,
    PKG_PROTOCOLS_25D,
    PKG_PROTOCOLS_3D,
    TechDB,
)
from .workload import Mapping


class InvalidSystem(ValueError):
    """Raised when a configuration violates a feasibility rule."""


@dataclasses.dataclass(frozen=True)
class HISystem:
    chiplets: Tuple[Chiplet, ...]
    style: str                       # 2D | 2.5D | 3D | 2.5D+3D
    memory: str                      # DDR4 | DDR5 | HBM2 | HBM3
    mapping: Mapping
    pkg_25d: Optional[str] = None    # RDL | EMIB | Passive | Active
    proto_25d: Optional[str] = None  # UCIe-S | UCIe-A | AIB | BoW
    pkg_3d: Optional[str] = None     # TSV | uBump | HybBond
    proto_3d: Optional[str] = None   # UCIe-3D
    # Indices of chiplets in the 3D stack (hybrid only; 3D uses all).
    stack: Tuple[int, ...] = ()
    # mesh_noc comm model (repro_torch.core.comm): per-chiplet
    # (mesh_dims_idx, entry_placement_idx) pairs. Empty = legacy pairwise
    # links; (0, 0) per chiplet is the bit-neutral single-tile mesh.
    noc: Tuple[Tuple[int, int], ...] = ()
    # window schedule model (repro_torch.core.schedule): one per-design
    # (start_hour, shape_idx) pair. None = fixed db.load_profile duty
    # weighting; (0, 0) is the bit-neutral always-on schedule.
    schedule: Optional[Tuple[int, int]] = None

    @property
    def n_chiplets(self) -> int:
        return len(self.chiplets)

    def describe(self) -> str:
        """Paper's I-P-M notation."""
        if self.style == "2D":
            return f"2D-NA-{self.memory}"
        if self.style == "2.5D":
            return f"2.5D-{self.pkg_25d}-{self.memory}"
        if self.style == "3D":
            return f"3D-{self.pkg_3d}-{self.memory}"
        return f"2.5D-{self.pkg_25d}-3D-{self.pkg_3d}-{self.memory}"

    # -- canonical 3D stack order: non-increasing area from the base up ----

    def stack_order(self, db: TechDB = DEFAULT_DB) -> Tuple[int, ...]:
        """Chiplet indices ordered base-first (largest area at the bottom)."""
        idx = self.stack if self.style == "2.5D+3D" else tuple(
            range(self.n_chiplets))
        return tuple(sorted(idx, key=lambda i: -self.chiplets[i].area_mm2(db)))

    def planar_indices(self) -> Tuple[int, ...]:
        """Chiplets placed side-by-side in the 2.5D plane. For hybrid
        systems the stack occupies one planar slot (its base die)."""
        if self.style in ("2D", "3D"):
            return ()
        if self.style == "2.5D":
            return tuple(range(self.n_chiplets))
        return tuple(i for i in range(self.n_chiplets) if i not in self.stack)


def validate(sys: HISystem, db: TechDB = DEFAULT_DB,
             max_chiplets: int = 6) -> None:
    """Feasibility checks (Sec V-A). Raises :class:`InvalidSystem`."""
    n = sys.n_chiplets
    if n < 1 or n > max_chiplets:
        raise InvalidSystem(f"chiplet count {n} outside [1, {max_chiplets}]")
    if sys.memory not in db.memories:
        raise InvalidSystem(f"unknown memory {sys.memory}")
    if sys.mapping.dataflow not in ("OS", "WS", "IS"):
        raise InvalidSystem(f"bad dataflow {sys.mapping.dataflow}")
    for c in sys.chiplets:
        if c.node not in db.tech_nodes or c.array not in db.array_sizes:
            raise InvalidSystem(f"chiplet {c.name} outside library")
        if c.sram_kb not in db.sram_sizes_kb[c.array]:
            raise InvalidSystem(f"chiplet {c.name} SRAM not in library")
    if sys.noc:
        from .comm import validate_noc
        try:
            validate_noc(sys.noc, n)
        except ValueError as e:
            raise InvalidSystem(f"bad noc assignment: {e}") from e
    if sys.schedule is not None:
        from .schedule import validate_schedule
        try:
            validate_schedule(sys.schedule)
        except ValueError as e:
            raise InvalidSystem(f"bad schedule: {e}") from e

    if sys.style == "2D":
        if n != 1:
            raise InvalidSystem("2D (monolithic) requires exactly 1 chiplet")
        if sys.pkg_25d or sys.pkg_3d:
            raise InvalidSystem("2D carries no package interconnect")
        return

    if n < 2:
        raise InvalidSystem(f"{sys.style} requires >= 2 chiplets")

    if sys.style == "2.5D":
        _check_25d(sys)
        if sys.pkg_3d or sys.proto_3d or sys.stack:
            raise InvalidSystem("2.5D system carries 3D fields")
    elif sys.style == "3D":
        _check_3d(sys)
        if sys.pkg_25d or sys.proto_25d:
            raise InvalidSystem("3D system carries 2.5D fields")
    elif sys.style == "2.5D+3D":
        if n < 3:
            raise InvalidSystem(
                "2.5D+3D misclassification: needs >= 3 chiplets")
        _check_25d(sys)
        _check_3d(sys)
        if len(sys.stack) < 2:
            raise InvalidSystem("hybrid stack needs >= 2 chiplets")
        if len(sys.stack) >= n:
            raise InvalidSystem("hybrid needs >= 1 planar (non-stack) chiplet")
        if len(set(sys.stack)) != len(sys.stack) or any(
                i < 0 or i >= n for i in sys.stack):
            raise InvalidSystem("bad stack indices")
    else:
        raise InvalidSystem(f"unknown integration style {sys.style}")


def _check_25d(sys: HISystem) -> None:
    protos = PKG_PROTOCOLS_25D.get(sys.pkg_25d or "")
    if protos is None:
        raise InvalidSystem(f"unknown 2.5D interconnect {sys.pkg_25d}")
    if sys.proto_25d not in protos:
        raise InvalidSystem(
            f"protocol {sys.proto_25d} incompatible with {sys.pkg_25d}")


def _check_3d(sys: HISystem) -> None:
    protos = PKG_PROTOCOLS_3D.get(sys.pkg_3d or "")
    if protos is None:
        raise InvalidSystem(f"unknown 3D interconnect {sys.pkg_3d}")
    if sys.proto_3d not in protos:
        raise InvalidSystem(
            f"protocol {sys.proto_3d} incompatible with {sys.pkg_3d}")


def is_valid(sys: HISystem, db: TechDB = DEFAULT_DB,
             max_chiplets: int = 6) -> bool:
    try:
        validate(sys, db, max_chiplets)
        return True
    except InvalidSystem:
        return False


def style_for_count(n: int, prefer: str) -> str:
    """Dynamic HI-type adjustment when a chiplet-count move invalidates the
    current style (Sec V-B, chip-architecture moves)."""
    if n == 1:
        return "2D"
    if n == 2 and prefer == "2.5D+3D":
        return "3D"
    if n >= 2 and prefer == "2D":
        return "2.5D"
    return prefer
