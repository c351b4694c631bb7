"""Dollar-cost model (Sec IV-D, Eqs. 15-16).

M_system = (sum_i M_chiplet_i + M_interposer + M_pkg) / Y_bonding + M_mem

Chiplet cost = wafer cost / dies-per-wafer / die yield (negative binomial).
Interposer cost applies only to active/passive 2.5D interposers and is
modeled as a 65nm silicon die of the floorplanned package area. Bonding
yield compounds per bonding event and depends on the interconnect type.
"""
from __future__ import annotations

import dataclasses

from .chiplet import Chiplet
from .system import HISystem
from .techdb import DEFAULT_DB, TechDB


def chiplet_cost(ch: Chiplet, db: TechDB = DEFAULT_DB) -> float:
    """Eq. 16."""
    area = ch.area_mm2(db)
    wafer = db.node_wafer_cost[ch.node]
    dpw = db.dies_per_wafer(area)
    y = db.die_yield(area, ch.node)
    return wafer / dpw / y


def bonding_yield(sys: HISystem, db: TechDB = DEFAULT_DB) -> float:
    """Compound bonding yield over all assembly events. 2.5D placements
    each incur one attach; a 3D stack incurs one bond per tier interface."""
    if sys.style == "2D":
        return 1.0
    y = 1.0
    if sys.style in ("2.5D", "2.5D+3D"):
        pkg = db.packages[sys.pkg_25d]
        n_attach = len(sys.planar_indices())
        if sys.style == "2.5D+3D":
            n_attach += 1  # the stack's base die is one planar attach
        y *= pkg.bonding_yield ** n_attach
    if sys.style in ("3D", "2.5D+3D"):
        pkg = db.packages[sys.pkg_3d]
        n_bonds = (len(sys.stack) if sys.style == "2.5D+3D"
                   else sys.n_chiplets) - 1
        y *= pkg.bonding_yield ** max(0, n_bonds)
    return y


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    chiplets: float
    interposer: float
    package: float
    memory: float
    bonding_yield: float

    @property
    def total(self) -> float:
        return ((self.chiplets + self.interposer + self.package)
                / self.bonding_yield + self.memory)


def interposer_cost(area_mm2: float, db: TechDB = DEFAULT_DB) -> float:
    """65nm silicon interposer die of the packaged area [3], [45]."""
    dpw = db.dies_per_wafer(area_mm2)
    y = db.interposer_yield(area_mm2)
    return db.interposer_wafer_cost / dpw / y


def system_cost(sys: HISystem, package_area_mm2: float,
                db: TechDB = DEFAULT_DB) -> CostBreakdown:
    """Eq. 15. ``package_area_mm2`` comes from the area model (floorplan
    bbox for 2.5D/hybrid, base-die area for 3D, die area for 2D)."""
    chiplets = sum(chiplet_cost(c, db) for c in sys.chiplets)
    interposer = 0.0
    if sys.style in ("2.5D", "2.5D+3D") and sys.pkg_25d in ("Passive", "Active"):
        interposer = interposer_cost(package_area_mm2, db)
    # assembly: one attach/bond event per chiplet, priced by interconnect
    assembly = 0.0
    if sys.style == "2D":
        assembly = db.assembly_cost
    if sys.style in ("2.5D", "2.5D+3D"):
        n_planar = len(sys.planar_indices())
        if sys.style == "2.5D+3D":
            n_planar += 1  # the stack base is one planar attach
        assembly += (n_planar * db.assembly_cost
                     * db.packages[sys.pkg_25d].cost_scale)
    if sys.style in ("3D", "2.5D+3D"):
        n_stack = len(sys.stack) if sys.style == "2.5D+3D" else sys.n_chiplets
        assembly += (n_stack * db.assembly_cost
                     * db.packages[sys.pkg_3d].cost_scale)
    package = db.substrate_cost_mm2 * package_area_mm2 + assembly
    memory = db.memories[sys.memory].cost_usd
    return CostBreakdown(chiplets, interposer, package, memory,
                         bonding_yield(sys, db))
