"""Carbon-footprint models (Sec II-B, Eqs. 2-4), after ECO-CHIP [3]/ACT [16].

Embodied CFP: per-chiplet manufacturing carbon (area x node carbon-per-area,
inflated by die-yield scrap, plus the per-die share of the wafer's scrapped
edge area, discounted by recycling credits) + amortized design carbon +
heterogeneous-integration carbon (packaging interconnect, interposer,
substrate, router share, inflated by bonding-yield scrap).

ECO-CHIP term map (each function's docstring names its equation):

* ``chiplet_mfg_cfp``   -> ECO-CHIP ``carbon = cpa*area/yield + wastage``
  with the ACT recycling credit ``(1-rcy_mat)(1-rcy_cpa)``.
* ``wasted_die_cfp``    -> ECO-CHIP ``waste_carbon_per_die``: the wafer
  area no whole die fits on still burned CPA energy; amortized per die.
* ``packaging_cfp``     -> ECO-CHIP ``package_costs`` package term
  (Eq. 2's C_HI).
* ``embodied_cfp``      -> Eq. 2 total, adding the ECO-CHIP ``router_c``
  split (``router_area_frac`` of each die's manufacturing carbon is NoC).
* ``operational_cfp``   -> Eq. 3, generalized to a 24h grid-intensity
  profile dotted with a diurnal load profile (Carbon Connect).

Every lifecycle knob defaults to a *neutral* value (0.0 addend, 1.0
multiplier, flat profile): with defaults, all functions reproduce their
pre-lifecycle outputs bit-for-bit.

Operational CFP: Eq. 3. E_system is the per-execution energy of the
workload; the device re-runs it back-to-back for the active fraction of its
lifetime, so the fleet-lifetime emission is
    (E_system / L_system) [W] x active-hours x C_src x N_vol.

Perf-SI (Eq. 4): throughput per unit carbon = 1 / (latency x C_sys).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .chiplet import Chiplet
from .system import HISystem
from .cost import bonding_yield
from .techdb import DEFAULT_DB, TechDB

SECONDS_PER_YEAR = 365.25 * 24 * 3600


def recycling_credit(db: TechDB = DEFAULT_DB) -> float:
    """ACT/ECO-CHIP recycling discount on manufacturing carbon:
    ``(1 - rcy_mat_frac) * (1 - rcy_cpa_frac)``.

    ``rcy_mat_frac`` credits recycled raw material, ``rcy_cpa_frac``
    credits the recycled share of the carbon-per-area energy bill; both
    are clamped to [0, 1] by ``TechDB``. Defaults (0, 0) give a factor
    of exactly 1.0."""
    return (1.0 - db.rcy_mat_frac) * (1.0 - db.rcy_cpa_frac)


def wasted_die_cfp(die_area_mm2: float, node: int,
                   db: TechDB = DEFAULT_DB) -> float:
    """ECO-CHIP ``waste_carbon_per_die``: wafer edge/scrap carbon per die.

    A wafer of area ``pi r^2`` yields ``DPW`` whole dies; the remaining
    ``pi r^2 - DPW * A`` mm^2 still burned CPA(node) energy and is
    amortized over the good dies:

        C_waste = cpa(node) * (wafer_area - DPW * A) / DPW

    scaled by ``db.wasted_die_scale`` (0.0 default = term off, so the
    pre-lifecycle manufacturing carbon is reproduced exactly)."""
    if db.wasted_die_scale == 0.0:
        return 0.0
    dpw = db.dies_per_wafer(die_area_mm2)
    scrap_mm2 = db.wafer_area_mm2() - dpw * die_area_mm2
    return db.wasted_die_scale * db.node_cpa[node] * scrap_mm2 / dpw


def chiplet_mfg_cfp(ch: Chiplet, db: TechDB = DEFAULT_DB) -> float:
    """C_mfg,i(n): ECO-CHIP ``carbon = cpa*area/yield + wastage_extra_cfp``.

    Area x CPA(node), divided by die yield — scrapped dies waste their
    embodied carbon — plus the per-die share of the wafer's scrapped
    area (:func:`wasted_die_cfp`), all discounted by the recycling
    credit (:func:`recycling_credit`). With default knobs this is
    bit-identical to plain ``area * cpa / yield``."""
    area = ch.area_mm2(db)
    mfg = area * db.node_cpa[ch.node] / db.die_yield(area, ch.node)
    mfg = mfg + wasted_die_cfp(area, ch.node, db)
    return mfg * recycling_credit(db)


def chiplet_design_cfp(ch: Chiplet, db: TechDB = DEFAULT_DB) -> float:
    """C_des,i / N_vol: design/NRE carbon amortized over production volume."""
    return db.node_design_cfp[ch.node] / db.production_volume


@dataclasses.dataclass(frozen=True)
class EmbodiedBreakdown:
    manufacturing: float        # incl. wasted-die share and recycling credit
    design: float
    packaging: float            # C_HI incl. the router (NoC) split

    @property
    def total(self) -> float:
        return self.manufacturing + self.design + self.packaging


def packaging_cfp(sys: HISystem, package_area_mm2: float,
                  db: TechDB = DEFAULT_DB) -> float:
    """C_HI: interconnect + interposer + substrate carbon, inflated by the
    bonding-yield scrap of whole assemblies (ECO-CHIP ``package_costs``
    package term).

    The final division deliberately covers the *entire* C_HI — including
    the base substrate term that a 2D system gets yield-free: when a
    2.5D/3D bonding event fails, the whole assembly (substrate included)
    is scrapped, so every packaging gram must be re-spent. This matches
    ECO-CHIP, which scales the full package carbon by assembly yield;
    2D packages undergo no bonding events (``bonding_yield`` == 1.0
    exactly), so the early return is a shortcut, not an asymmetry — the
    scalar and device paths agree bitwise (pinned by the
    ``packaging_cfp`` parity test)."""
    if sys.style == "2D":
        return db.substrate_cfp_mm2 * package_area_mm2
    cfp = db.substrate_cfp_mm2 * package_area_mm2
    if sys.style in ("2.5D", "2.5D+3D"):
        pkg = db.packages[sys.pkg_25d]
        cfp += pkg.cfp_kg_per_mm2 * package_area_mm2
        if sys.pkg_25d in ("Passive", "Active"):
            cfp += (package_area_mm2 * db.interposer_cpa
                    / db.interposer_yield(package_area_mm2))
    if sys.style in ("3D", "2.5D+3D"):
        pkg = db.packages[sys.pkg_3d]
        order = sys.stack_order(db)
        bonded_area = sum(sys.chiplets[i].area_mm2(db) for i in order[1:])
        cfp += pkg.cfp_kg_per_mm2 * bonded_area
    return cfp / bonding_yield(sys, db)


def embodied_cfp(sys: HISystem, package_area_mm2: float,
                 db: TechDB = DEFAULT_DB) -> EmbodiedBreakdown:
    """Eq. 2, with the ECO-CHIP packaging/router carbon split.

    ECO-CHIP's ``package_costs`` returns ``(package_c, router_c)`` and
    charges ``package_c + router_c`` to integration: the on-die routers
    (NoC share ``db.router_area_frac`` of each die) belong to the
    *integration* bill, not the compute bill. Router carbon is the NoC
    share of total manufacturing carbon and — like ECO-CHIP's
    ``router_c`` — does not pay the bonding-yield inflation (routers on
    good dies are not re-spent when a bond fails; the die is recovered
    carbon-wise through the die-yield term). ``router_area_frac=0.0``
    (default) reproduces the pre-split packaging carbon exactly.

    Under the mesh_noc comm model (``sys.noc`` non-empty) each chiplet's
    router share scales with its physical router count ``mx * my`` —
    structure-proportional instead of a flat area fraction. The neutral
    ``(1, 1)`` mesh multiplies by exactly 1.0 per chiplet, reproducing
    the legacy term bit-for-bit."""
    per_chip = [chiplet_mfg_cfp(c, db) for c in sys.chiplets]
    mfg = sum(per_chip)
    des = sum(chiplet_design_cfp(c, db) for c in sys.chiplets)
    pkg = packaging_cfp(sys, package_area_mm2, db)
    if sys.noc:
        from .comm import system_n_routers
        routers = system_n_routers(sys)
        pkg = pkg + db.router_area_frac * sum(
            m * r for m, r in zip(per_chip, routers))
    else:
        pkg = pkg + db.router_area_frac * mfg
    return EmbodiedBreakdown(mfg, des, pkg)


def effective_intensity(ci: float,
                        profile: Optional[Sequence[float]] = None,
                        load: Optional[Sequence[float]] = None) -> float:
    """Load-weighted effective grid intensity (Carbon Connect).

    With a 24h grid-intensity ``profile`` and a diurnal ``load``
    weighting (entries summing to 1), the effective intensity is

        ci_eff = ci + sum_h (profile[h] - ci) * load[h]

    i.e. the scalar ``ci`` plus a correction that is *exactly* +0.0
    when the profile is flat at ``ci`` (every term is 0.0), so flat
    profiles are bit-identical to the scalar model. This formulation —
    not ``sum(profile * load)`` — is what the device program computes,
    keeping scalar and fused paths aligned."""
    if profile is None:
        return ci
    if load is None:
        load = (1.0 / len(profile),) * len(profile)
    corr = 0.0
    for p, l in zip(profile, load):
        corr += (p - ci) * l
    return ci + corr


def effective_price(price: float,
                    profile: Optional[Sequence[float]] = None,
                    load: Optional[Sequence[float]] = None) -> float:
    """Load-weighted effective electricity price — the dollar-metric twin
    of :func:`effective_intensity`, sharing its ``price + sum((p - price)
    * load)`` formulation so a flat curve contributes exactly +0.0 and a
    ``None`` curve is the scalar price bit-for-bit."""
    return effective_intensity(price, profile, load)


def lifetime_kwh(energy_j: float, db: TechDB = DEFAULT_DB) -> float:
    """Lifetime electrical energy (kWh) of one deployed unit: per-run
    energy x (duty_runs_per_s x active seconds) under the fixed-demand
    deployment model."""
    active_s = db.lifetime_years * SECONDS_PER_YEAR * db.use_fraction
    runs = db.duty_runs_per_s * active_s
    return energy_j * runs / 3.6e6


def operational_cost_usd(energy_j: float, db: TechDB = DEFAULT_DB,
                         load: Optional[Sequence[float]] = None) -> float:
    """Lifetime electricity bill of one unit: lifetime kWh x regional
    effective price. With the default flat ``db.price_profile=None`` the
    effective price *is* ``db.electricity_price`` ($/kWh) bit-for-bit;
    a 24h price curve is load-weighted like the grid intensity
    (:func:`effective_price`), ``load`` overriding ``db.load_profile``
    for schedule-carrying designs. The neutral default price of 0.0
    leaves the manufacturing-only dollar metric unchanged (x + 0.0 is
    bit-identical for finite x)."""
    price = effective_price(db.electricity_price, db.price_profile,
                            db.load_profile if load is None else load)
    return lifetime_kwh(energy_j, db) * price


def operational_cfp(energy_j: float, latency_s: float,
                    db: TechDB = DEFAULT_DB, per_unit: bool = False,
                    load: Optional[Sequence[float]] = None) -> float:
    """Eq. 3 under a fixed-demand deployment: the system executes the
    workload ``duty_runs_per_s`` times per active second over its lifetime,
    so lifetime emissions scale with per-run energy (which itself carries a
    static-power x latency term added in ``evaluate``). The grid intensity
    is the load-weighted :func:`effective_intensity` of ``db.grid_profile``
    (``None`` = flat = the scalar ``db.carbon_intensity``, bit-identical).
    ``load`` overrides ``db.load_profile`` for designs carrying an
    encoded schedule (see :mod:`repro_torch.core.schedule`); ``None`` keeps
    the fixed per-db weighting bit-for-bit.
    Returns fleet lifetime kgCO2e, or per-unit with ``per_unit=True``."""
    del latency_s  # latency enters through the static-energy term upstream
    kwh = lifetime_kwh(energy_j, db)
    ci = effective_intensity(db.carbon_intensity, db.grid_profile,
                             db.load_profile if load is None else load)
    volume = 1 if per_unit else db.production_volume
    return kwh * ci * volume


def perf_si(latency_s: float, total_cfp: float) -> float:
    """Eq. 4 with Performance = 1/latency so that higher is better."""
    return 1.0 / (latency_s * total_cfp)
