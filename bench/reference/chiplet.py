"""Chiplet library: pre-designed systolic-array AI accelerator dies.

Each chiplet is identified by the paper's A-T-S notation (array size -
tech node - SRAM KB), e.g. ``128-7-1024``. Area and power derive from the
synthesis-calibrated 7nm values in :mod:`repro_torch.core.techdb`, scaled per
node. The library enumerates every valid (A, T, S) combination of Table II.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

from .techdb import DEFAULT_DB, TechDB


@dataclasses.dataclass(frozen=True)
class Chiplet:
    """A characterized accelerator die drawn from the chiplet library."""

    array: int          # systolic array dimension (array x array PEs)
    node: int           # technology node, nm
    sram_kb: int        # on-chip buffer capacity (split into 3 equal buffers)

    @property
    def name(self) -> str:
        return f"{self.array}-{self.node}-{self.sram_kb}"

    @classmethod
    def parse(cls, name: str) -> "Chiplet":
        a, t, s = name.split("-")
        return cls(int(a), int(t), int(s))

    # -- physical characterization -----------------------------------------

    def area_mm2(self, db: TechDB = DEFAULT_DB) -> float:
        logic = db.array_area_7nm[self.array]
        sram = db.sram_area_per_kb * self.sram_kb
        return (logic + sram) * db.node_area_scale[self.node]

    def power_w(self, db: TechDB = DEFAULT_DB) -> float:
        dyn = db.array_power_7nm[self.array] * db.node_power_scale[self.node]
        leak = 2.0e-5 * self.sram_kb * db.node_power_scale[self.node]
        # power scales with achievable frequency at the node
        return (dyn + leak) * db.freq_ghz(self.node)

    def static_power_w(self, db: TechDB = DEFAULT_DB) -> float:
        """Leakage + clock-tree power burned whenever the system is on;
        charged per second of system latency in the energy model."""
        return db.static_power_fraction * self.power_w(db)

    def freq_ghz(self, db: TechDB = DEFAULT_DB) -> float:
        return db.freq_ghz(self.node)

    def peak_macs_per_s(self, db: TechDB = DEFAULT_DB) -> float:
        return self.array * self.array * self.freq_ghz(db) * 1e9

    @property
    def pe_count(self) -> int:
        return self.array * self.array

    def compute_power_ratio(self, db: TechDB = DEFAULT_DB) -> float:
        """Relative compute throughput p_p used by Algorithm 1 line 6."""
        return self.array * self.array * self.freq_ghz(db)

    def side_mm(self, db: TechDB = DEFAULT_DB) -> float:
        """Assume square dies; side length for bump-count models (Eq. 7)."""
        return math.sqrt(self.area_mm2(db))

    def perimeter_mm(self, db: TechDB = DEFAULT_DB) -> float:
        return 4.0 * self.side_mm(db)

    def buffer_bytes_each(self) -> int:
        """Three equally sized on-chip buffers (ifmap/filter/ofmap)."""
        return (self.sram_kb * 1024) // 3


def library(db: TechDB = DEFAULT_DB) -> Tuple[Chiplet, ...]:
    """Full chiplet library: every valid (A, T, S) from Table II."""
    return tuple(iter_library(db))


def iter_library(db: TechDB = DEFAULT_DB) -> Iterator[Chiplet]:
    for array in db.array_sizes:
        for node in db.tech_nodes:
            for sram in db.sram_sizes_kb[array]:
                yield Chiplet(array, node, sram)


# Named systems used throughout the paper's experiments (Sec VI-A).
def identical_chiplet_system(n: int = 4) -> Tuple[Chiplet, ...]:
    """*identical chiplet system*: n x 128-7-1024."""
    return tuple(Chiplet(128, 7, 1024) for _ in range(n))


def different_chiplet_system() -> Tuple[Chiplet, ...]:
    """*different chiplet system*: 64-7-256, 96-7-512, 128-7-1024, 192-7-2048."""
    return (
        Chiplet(64, 7, 256),
        Chiplet(96, 7, 512),
        Chiplet(128, 7, 1024),
        Chiplet(192, 7, 2048),
    )
