"""End-to-end PPAC + CFP evaluation of an HI system on a GEMM workload.

Implements the paper's system latency (Eq. 5), energy (Eqs. 12-14), area
(Sec IV-C), dollar cost (Eq. 15), CFP (Eqs. 2-3) and Perf-SI (Eq. 4) on
top of the tiler (Algorithm 1), the analytical systolic model, the
topology-aware D2D model, and the slicing floorplanner.

Modeling note (documented divergence): Sec IV-A's assumed dataflow routes
every chiplet's intermediate results to the *destination* chiplet, while
Sec IV-A's write model makes DRAM write-back split-K dependent. We honor
both: reduction-phase D2D traffic always flows to the destination —
32-bit partial sums when split-K is on (multiple per output region),
8-bit final outputs when off — and write-back is performed by the
destination alone iff split-K is on. This reproduces Fig. 5's non-zero,
topology-dependent D2D latency under x-x-0 mappings and Fig. 12's split-K
bandwidth asymmetry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import carbon as carbon_mod
from . import cost as cost_mod
from . import d2d as d2d_mod
from . import scalesim as sim_mod
from .scalesim import OPERAND_BYTES, PSUM_BYTES, SimCache
from .system import HISystem
from .techdb import DEFAULT_DB, TechDB
from .workload import (
    DEFAULT_TILE,
    GEMMWorkload,
    tile_and_assign,
)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """Everything the SA cost function (Eq. 17) and the analyses consume."""

    latency_s: float
    energy_j: float
    area_mm2: float
    dollar: float
    emb_cfp_kg: float
    ope_cfp_kg: float
    # components, for the figure-level analyses
    l_compute_rd_s: float
    l_d2d_s: float
    l_dram_wr_s: float
    e_compute_j: float
    e_d2d_j: float
    d2d_bits: int
    macs: int

    @property
    def total_cfp(self) -> float:
        return self.emb_cfp_kg + self.ope_cfp_kg

    @property
    def perf_si(self) -> float:
        return carbon_mod.perf_si(self.latency_s, self.total_cfp)


def package_area_mm2(sys: HISystem, topo: d2d_mod.Topology,
                     db: TechDB = DEFAULT_DB) -> float:
    """Area model (Sec IV-C): die area for 2D, base-die area for 3D,
    floorplan bounding box (with white space) for 2.5D / hybrid."""
    if sys.style == "2D":
        return sys.chiplets[0].area_mm2(db)
    if sys.style == "3D":
        assert topo.base_die is not None
        return sys.chiplets[topo.base_die].area_mm2(db)
    assert topo.floorplan is not None
    return topo.floorplan.bbox_area


def evaluate(
    sys: HISystem,
    wl: GEMMWorkload,
    db: TechDB = DEFAULT_DB,
    tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
    cache: Optional[SimCache] = None,
) -> Metrics:
    cache = cache if cache is not None else SimCache()
    assignments = tile_and_assign(wl, sys.chiplets, sys.mapping, tile_sizes, db)
    topo = d2d_mod.build_topology(sys, db)
    mem = db.memories[sys.memory]

    # -- per-chiplet simulation (cached, Sec V-D) ---------------------------
    sims = [
        cache.simulate(a.tiles, a.core, sys.mapping.dataflow)
        for a in assignments
    ]

    # -- Eq. 5 term 1: max_i (L_compute,i + L_DRAM_RD,i) --------------------
    l_cr = 0.0
    for i, (a, s) in enumerate(zip(assignments, sims)):
        l_comp = sim_mod.compute_latency_s(s, a.core, db)
        bw = topo.effective_dram_bw(i)
        l_rd = s.dram_rd_bits / bw if s.dram_rd_bits else 0.0
        l_cr = max(l_cr, l_comp + l_rd)

    # -- Eq. 5 term 2: reduction-phase D2D ----------------------------------
    src_bits = []
    for i, a in enumerate(assignments):
        if i == topo.dest:
            src_bits.append(0)
            continue
        bits = 0
        for t in a.tiles:
            width = PSUM_BYTES if t.partial else OPERAND_BYTES
            bits += t.m * t.n * width * 8
        src_bits.append(bits)
    d2d = d2d_mod.route_reduction(topo, src_bits)

    # -- Eq. 5 term 3: DRAM write-back (split-K dependent) ------------------
    if sys.mapping.split_k:
        # destination reduces the partials, requantizes, writes once
        wr_bits = wl.M * wl.N * OPERAND_BYTES * 8
        l_wr = wr_bits / topo.effective_dram_bw(topo.dest)
    else:
        l_wr = 0.0
        for i, s in enumerate(sims):
            if s.dram_wr_bits:
                l_wr = max(l_wr, s.dram_wr_bits / topo.effective_dram_bw(i))

    latency = l_cr + d2d.latency_s + l_wr

    # -- energy (Eqs. 12-14) ------------------------------------------------
    e_compute = 0.0
    e_mem_d2d_pj = 0.0
    for i, (a, s) in enumerate(zip(assignments, sims)):
        node = a.core.node
        e_compute += s.dram_rd_bits * mem.energy_pj_bit_rd
        e_compute += s.dram_wr_bits * mem.energy_pj_bit_wr
        e_compute += s.sram_bits * db.sram_energy_pj_bit(node)
        e_compute += s.macs * db.mac_energy_pj(node)
        # compute-memory D2D (3D stacks route DRAM traffic via the base die)
        e_mem_d2d_pj += ((s.dram_rd_bits + s.dram_wr_bits)
                         * topo.dram_path_energy_pj_bit(i))
    e_d2d_pj = d2d.energy_pj + e_mem_d2d_pj
    e_compute_j = e_compute * 1e-12
    e_d2d_j = e_d2d_pj * 1e-12
    # static power burns for the whole system latency — this is the term
    # through which faster execution lowers energy and operational CFP.
    e_static_j = sum(c.static_power_w(db) for c in sys.chiplets) * latency
    energy = e_compute_j + e_d2d_j + e_static_j

    # -- area, cost, carbon ---------------------------------------------------
    # Regional axes (all default-neutral, see repro_torch.core.carbon): the
    # lifetime electricity bill joins the dollar metric (price 0.0 ->
    # +0.0), the regional fab-grid factor scales embodied carbon
    # (factor 1.0 -> x1.0), and operational CFP dots the 24h grid
    # profile with the load profile (flat -> scalar, bit-identical).
    area = package_area_mm2(sys, topo, db)
    cost = cost_mod.system_cost(sys, area, db)
    # Encoded schedule (repro_torch.core.schedule): a (start, shape) design
    # axis overrides the fixed db.load_profile duty weighting for the
    # operational terms. None keeps the legacy path verbatim; the
    # neutral (0, 0) schedule decodes to db.load_profile's own values,
    # so it is bit-identical too.
    if sys.schedule is not None:
        from .schedule import schedule_load_row
        load = schedule_load_row(sys.schedule, db)
    else:
        load = None
    dollar = cost.total + carbon_mod.operational_cost_usd(energy, db,
                                                          load=load)
    emb = carbon_mod.embodied_cfp(sys, area, db)
    ope = carbon_mod.operational_cfp(energy, latency, db, per_unit=True,
                                     load=load)

    return Metrics(
        latency_s=latency,
        energy_j=energy,
        area_mm2=area,
        dollar=dollar,
        emb_cfp_kg=emb.total * db.emb_factor,
        ope_cfp_kg=ope,
        l_compute_rd_s=l_cr,
        l_d2d_s=d2d.latency_s,
        l_dram_wr_s=l_wr,
        e_compute_j=e_compute_j,
        e_d2d_j=e_d2d_j,
        d2d_bits=d2d.total_bits,
        macs=sum(s.macs for s in sims),
    )
