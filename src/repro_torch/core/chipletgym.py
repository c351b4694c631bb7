"""ChipletGym-style baseline models [18] (Sec VI-B comparisons).

Reproduces the simplifying assumptions the paper criticizes:
  * fixed D2D latency — 17.2 ps for 2.5D, 1.6 ps for 3D — independent of
    interconnect, topology, chiplet count or size;
  * energy = energy-per-MAC only (no DRAM, SRAM or protocol overheads);
  * constant bonding yield of 0.99 for every packaging type;
  * no area term and no CFP in the optimization objective.

The evaluator has the signature of
:func:`repro_torch.core.evaluate.evaluate`. It is the
``objective="chipletgym"`` backend of
:class:`repro_torch.pathfinding.Pathfinder`; batched strategies fall back
to per-row scalar evaluation on the host for it.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core import cost as cost_mod
from repro_torch.core import d2d as d2d_mod
from repro_torch.core import scalesim as sim_mod
from repro_torch.core.evaluate import Metrics, package_area_mm2
from repro_torch.core.scalesim import SimCache
from repro_torch.core.system import HISystem
from repro_torch.core.techdb import (
    CHIPLETGYM_BOND_YIELD,
    CHIPLETGYM_D2D_LATENCY_25D_S,
    CHIPLETGYM_D2D_LATENCY_3D_S,
    DEFAULT_DB,
    TechDB,
)
from repro_torch.core.workload import DEFAULT_TILE, GEMMWorkload, tile_and_assign


def evaluate_chipletgym(
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
    total_bw = mem.bw_gbs_per_channel * mem.max_channels * 8e9

    sims = [cache.simulate(a.tiles, a.core, sys.mapping.dataflow)
            for a in assignments]

    # compute + DRAM read, with a flat (non-topology) memory bandwidth share
    l_cr = 0.0
    for a, s in zip(assignments, sims):
        l_comp = sim_mod.compute_latency_s(s, a.core, db)
        l_rd = s.dram_rd_bits / (total_bw / max(1, sys.n_chiplets))
        l_cr = max(l_cr, l_comp + l_rd)

    # fixed per-hop D2D latency regardless of traffic or interconnect
    fixed = (CHIPLETGYM_D2D_LATENCY_3D_S if sys.style == "3D"
             else CHIPLETGYM_D2D_LATENCY_25D_S)
    l_d2d = 0.0 if sys.style == "2D" else fixed * (sys.n_chiplets - 1)

    l_wr = 0.0
    for s in sims:
        l_wr = max(l_wr, s.dram_wr_bits / (total_bw / max(1, sys.n_chiplets)))
    latency = l_cr + l_d2d + l_wr

    # energy: MAC energy only
    energy = sum(s.macs * db.mac_energy_pj(a.core.node)
                 for a, s in zip(assignments, sims)) * 1e-12

    area = package_area_mm2(sys, topo, db)
    chiplets = sum(cost_mod.chiplet_cost(c, db) for c in sys.chiplets)
    interposer = 0.0
    if sys.style in ("2.5D", "2.5D+3D") and sys.pkg_25d in ("Passive", "Active"):
        interposer = cost_mod.interposer_cost(area, db)
    package = db.substrate_cost_mm2 * area
    dollar = ((chiplets + interposer + package) / CHIPLETGYM_BOND_YIELD
              + mem.cost_usd)

    return Metrics(
        latency_s=latency,
        energy_j=energy,
        area_mm2=area,
        dollar=dollar,
        emb_cfp_kg=0.0,     # ChipletGym models no CFP
        ope_cfp_kg=0.0,
        l_compute_rd_s=l_cr,
        l_d2d_s=l_d2d,
        l_dram_wr_s=l_wr,
        e_compute_j=energy,
        e_d2d_j=0.0,
        d2d_bits=0,
        macs=sum(s.macs for s in sims),
    )
