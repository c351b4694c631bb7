"""Technology database for CarbonPATH.

Every constant the paper's models consume lives here, grouped by the design
spaces of Table II / Table III. Values are calibrated knobs sourced from the
paper's citations (ECO-CHIP [3], UCIe [35], AIB/Arvon [36], BoW [37],
CiM-3D [40], HBM/DRAM [41,42], wafer costs [46,52], ASAP7 synthesis [50]).
The paper normalizes all reported results (Sec. VII) — relative trend
fidelity, not absolute point estimates, is the contract; users override any
entry via ``TechDB(overrides={...})``.

Units used throughout the core package:
    area   mm^2        power  W           energy  pJ/bit
    bw     GB/s        freq   GHz         latency s
    pitch  um          cost   USD         carbon  kgCO2e
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Enumerations of the design space (Table II / Table III)
# ---------------------------------------------------------------------------

TECH_NODES = (7, 10, 14, 22, 28)                       # nm
ARRAY_SIZES = (64, 96, 128, 192)                       # systolic array dim
SRAM_SIZES_KB: Mapping[int, Tuple[int, ...]] = {       # per array size
    64: (256, 512, 768, 1024),
    96: (512, 1024, 1536, 2048),
    128: (1024, 2048, 3072, 4096),
    192: (2048, 4096, 6144, 8192),
}
MEMORY_TYPES = ("DDR4", "DDR5", "HBM2", "HBM3")
INTEGRATION_STYLES = ("2D", "2.5D", "3D", "2.5D+3D")
INTERCONNECTS_25D = ("RDL", "EMIB", "Passive", "Active")
INTERCONNECTS_3D = ("TSV", "uBump", "HybBond")
PROTOCOLS_25D = ("UCIe-S", "UCIe-A", "AIB", "BoW")
PROTOCOLS_3D = ("UCIe-3D",)
DATAFLOWS = ("OS", "WS", "IS")

# Table III — compatible (2.5D interconnect -> protocols)
PKG_PROTOCOLS_25D: Mapping[str, Tuple[str, ...]] = {
    "RDL": ("UCIe-S",),
    "EMIB": ("UCIe-A", "AIB", "BoW"),
    "Passive": ("UCIe-A", "AIB", "BoW"),
    "Active": ("UCIe-A", "AIB", "BoW"),
}
PKG_PROTOCOLS_3D: Mapping[str, Tuple[str, ...]] = {
    "TSV": ("UCIe-3D",),
    "uBump": ("UCIe-3D",),
    "HybBond": ("UCIe-3D",),
}


def valid_pairs_25d() -> Tuple[Tuple[str, str], ...]:
    return tuple(
        (pkg, proto)
        for pkg, protos in PKG_PROTOCOLS_25D.items()
        for proto in protos
    )


def valid_pairs_3d() -> Tuple[Tuple[str, str], ...]:
    return tuple(
        (pkg, proto)
        for pkg, protos in PKG_PROTOCOLS_3D.items()
        for proto in protos
    )


def valid_pairs_hybrid() -> Tuple[Tuple[str, str, str, str], ...]:
    """(2.5D pkg, 2.5D proto, 3D pkg, 3D proto) — 10 x 3 = 30 combos."""
    return tuple(
        (p25, pr25, p3, pr3)
        for (p25, pr25) in valid_pairs_25d()
        for (p3, pr3) in valid_pairs_3d()
    )


def all_pkg_protocol_pairs() -> int:
    """Paper Sec V-A: 10 (2.5D) + 3 (3D) + 30 (hybrid) = 43."""
    return len(valid_pairs_25d()) + len(valid_pairs_3d()) + len(valid_pairs_hybrid())


# ---------------------------------------------------------------------------
# Chiplet library physical characterization (synthesized ASAP7 @ 7nm, scaled)
# ---------------------------------------------------------------------------
# Base area/power at 7 nm per systolic array size (synthesis-calibrated
# placeholders). Area includes the PE array + control; SRAM added per KB.
# 12.5% activity factor is already folded into the dynamic power numbers.

ARRAY_AREA_7NM_MM2: Mapping[int, float] = {   # PE array logic area at 7nm
    64: 1.10, 96: 2.45, 128: 4.30, 192: 9.60,
}
ARRAY_POWER_7NM_W: Mapping[int, float] = {    # at 1 GHz, 12.5% activity
    64: 0.55, 96: 1.22, 128: 2.15, 192: 4.80,
}
SRAM_AREA_7NM_MM2_PER_KB = 0.0018             # high-density 7nm SRAM macro
SRAM_LEAK_W_PER_KB = 2.0e-5

# Node scaling tables (relative to 7nm = 1.0), after [3], [51].
NODE_AREA_SCALE: Mapping[int, float] = {7: 1.00, 10: 1.55, 14: 2.20, 22: 3.55, 28: 4.70}
NODE_POWER_SCALE: Mapping[int, float] = {7: 1.00, 10: 1.25, 14: 1.60, 22: 2.25, 28: 2.80}
NODE_FREQ_GHZ: Mapping[int, float] = {7: 1.00, 10: 0.90, 14: 0.80, 22: 0.65, 28: 0.55}

# Carbon intensity of manufacturing per mm^2 by node (kgCO2e/mm^2), after
# ECO-CHIP [3] / imec [30]: advanced nodes have higher per-area intensity
# (more EUV passes, higher energy litho).
NODE_CPA_KGCO2_MM2: Mapping[int, float] = {
    7: 0.0460, 10: 0.0390, 14: 0.0320, 22: 0.0250, 28: 0.0210,
}
# Defect density per node (defects/mm^2) for negative-binomial yield [47-49]
NODE_DEFECT_MM2: Mapping[int, float] = {
    7: 0.0014, 10: 0.0012, 14: 0.0010, 22: 0.0008, 28: 0.0007,
}
# Wafer cost by node (300 mm wafer, USD) from [46], [52]
NODE_WAFER_COST: Mapping[int, float] = {
    7: 9346.0, 10: 5992.0, 14: 3984.0, 22: 3238.0, 28: 2612.0,
}
# Design (NRE) carbon per chiplet by node (kgCO2e), amortized over volume.
NODE_DESIGN_CFP_KGCO2: Mapping[int, float] = {
    7: 1.8e6, 10: 1.2e6, 14: 0.8e6, 22: 0.5e6, 28: 0.4e6,
}

WAFER_DIAMETER_MM = 300.0
YIELD_CLUSTER_ALPHA = 2.0          # negative binomial clustering parameter

# ---------------------------------------------------------------------------
# Protocols (UCIe [35], AIB [36], BoW [37]) — PHY characteristics
# ---------------------------------------------------------------------------


# Per-hop switch/PHY latency of a package-level D2D link. The neutral
# default matches the pre-refactor module constant ``d2d.HOP_LATENCY_S``
# exactly: with every protocol at this value the routed hop term is
# computed as ``max_hops * h`` — bit-identical to all pinned goldens.
DEFAULT_HOP_LATENCY_S = 2.0e-9


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    name: str
    data_rate_gbps: float      # per bump/wire lane
    efficiency: float          # eta_protocol: payload fraction after framing
    energy_pj_bit: float       # D2D link energy per bit
    max_bump_pitch_um: float   # coarsest pitch the PHY tolerates
    hop_latency_s: float = DEFAULT_HOP_LATENCY_S   # per-hop switch/PHY


PROTOCOLS: Mapping[str, ProtocolSpec] = {
    # 2.5D standard-package UCIe: 16 GT/s, ~25um+ pitch
    "UCIe-S": ProtocolSpec("UCIe-S", 16.0, 0.80, 0.50, 130.0),
    # 2.5D advanced-package UCIe: 32 GT/s on fine pitch
    "UCIe-A": ProtocolSpec("UCIe-A", 32.0, 0.83, 0.30, 55.0),
    "AIB": ProtocolSpec("AIB", 6.4, 0.90, 0.50, 55.0),
    "BoW": ProtocolSpec("BoW", 16.0, 0.88, 0.45, 55.0),
    # 3D UCIe: short vertical hops, very low pJ/bit
    "UCIe-3D": ProtocolSpec("UCIe-3D", 4.0, 0.92, 0.05, 10.0),
}

# ---------------------------------------------------------------------------
# Packaging interconnects — bump pitch, bonding yield, carbon, cost
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackageSpec:
    name: str
    style: str                 # "2.5D" | "3D"
    bump_pitch_um: float       # D2D bump/via pitch
    bonding_yield: float       # per bonding event
    cfp_kg_per_mm2: float      # packaging embodied carbon per packaged mm^2
    cost_scale: float          # relative assembly cost multiplier
    wires_per_mm: float        # escape density for edge (2.5D) routing


PACKAGES: Mapping[str, PackageSpec] = {
    # 2.5D family — paper: RDL most mature/highest yield & lowest cost
    "RDL": PackageSpec("RDL", "2.5D", 110.0, 0.999, 0.0045, 1.00, 95.0),
    # EMIB: the dense silicon bridge (~250 wires/mm, fine BEOL layers)
    # carries the highest per-area embodied carbon of the 2.5D options
    "EMIB": PackageSpec("EMIB", "2.5D", 45.0, 0.990, 0.0300, 1.45, 250.0),
    "Passive": PackageSpec("Passive", "2.5D", 40.0, 0.990, 0.0110, 1.60, 220.0),
    "Active": PackageSpec("Active", "2.5D", 36.0, 0.985, 0.0130, 1.85, 240.0),
    # 3D family — paper: TSV cheapest 3D, hybrid bond lowest-yield/highest-cost
    "TSV": PackageSpec("TSV", "3D", 40.0, 0.980, 0.0150, 2.10, 0.0),
    "uBump": PackageSpec("uBump", "3D", 25.0, 0.970, 0.0170, 2.40, 0.0),
    "HybBond": PackageSpec("HybBond", "3D", 6.0, 0.955, 0.0210, 2.95, 0.0),
}

# ---------------------------------------------------------------------------
# Memory systems (JEDEC [39], HBM [41,42])
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    name: str
    bw_gbs_per_channel: float
    max_channels: int
    energy_pj_bit_rd: float
    energy_pj_bit_wr: float
    cost_usd: float            # per system memory subsystem
    cfp_kg: float              # embodied carbon of the memory stack


MEMORIES: Mapping[str, MemorySpec] = {
    "DDR4": MemorySpec("DDR4", 25.6, 4, 15.0, 15.0, 35.0, 4.5),
    "DDR5": MemorySpec("DDR5", 51.2, 4, 12.0, 12.0, 55.0, 5.5),
    "HBM2": MemorySpec("HBM2", 307.0, 8, 3.9, 3.9, 160.0, 14.0),
    "HBM3": MemorySpec("HBM3", 819.0, 8, 3.5, 3.5, 240.0, 19.0),
}

# SRAM access energy (pJ/bit) at 7nm from [40]; scales with node power.
SRAM_ENERGY_PJ_BIT_7NM = 0.18
# MAC energy (pJ per 8-bit MAC) at 7nm from synthesis; per-bit convention:
# E_compute is charged per bit processed = MAC energy / 8.
MAC_ENERGY_PJ_7NM = 0.32

# ---------------------------------------------------------------------------
# Operational carbon (Eq. 3)
# ---------------------------------------------------------------------------

CARBON_INTENSITY_KG_PER_KWH = 0.475   # world-average grid [16]
LIFETIME_YEARS = 5.0                  # 3-7y [31-33]
USE_FRACTION = 0.30                   # T_use: active fraction of lifetime
PRODUCTION_VOLUME = 1_000_000         # N_vol (paper Sec VI-A)
# Demand model for Eq. 3: the deployed system serves a fixed request rate
# over its active lifetime, so lifetime operational energy is
# E_system-per-run x (duty_runs_per_s x active seconds). Constant across
# candidates -> cancels under the paper's normalization.
DUTY_RUNS_PER_S = 5000.0
# Static (leakage + clock-tree) power fraction of peak dynamic power; it
# charges energy proportional to latency, which is how shorter execution
# lowers operational CFP (Sec VI-C3).
STATIC_POWER_FRACTION = 0.15

# --- lifecycle / regional axes (ECO-CHIP [3], Carbon Connect) -------------
# All defaults are *neutral*: with them, every model below reproduces the
# pre-lifecycle numbers bit-for-bit (0.0 addends, 1.0 multipliers, flat
# profiles), so goldens pinned before this axis existed stay valid.
HOURS_PER_DAY = 24
# Uniform diurnal duty weighting: the deployed system draws its lifetime
# energy evenly across the day unless a workload says otherwise. Entries
# sum to 1; pairs with a per-region 24h grid-intensity profile to turn
# operational CFP into a profile dot product (Carbon Connect).
FLAT_LOAD_PROFILE: Tuple[float, ...] = (1.0 / HOURS_PER_DAY,) * HOURS_PER_DAY
ELECTRICITY_PRICE_USD_PER_KWH = 0.0   # regional $/kWh; 0 = cost-model-only $
EMBODIED_REGION_FACTOR = 1.0          # regional fab-grid embodied multiplier
RCY_MAT_FRAC = 0.0                    # recycled raw-material fraction [0,1]
RCY_CPA_FRAC = 0.0                    # recycled share of CPA energy [0,1]
WASTED_DIE_SCALE = 0.0                # gate on per-wafer scrap carbon term
ROUTER_AREA_FRAC = 0.0                # on-die router share of chiplet area
# mesh-NoC knobs (repro_torch.core.comm): per-router-hop latency/energy of the
# on-chiplet mesh. Both are multiplied by the mean NoC hop count, which is
# exactly 0.0 at the neutral (1, 1) mesh — legacy results never see them.
NOC_HOP_LATENCY_S = 2.0e-10           # on-die router hop (10x faster than D2D)
NOC_ENERGY_PJ_BIT = 0.05              # on-die router+wire energy per bit-hop

# Interposer: fabricated at 65nm [3],[45]
INTERPOSER_NODE_CPA = 0.0125          # kgCO2e/mm^2 at 65nm
INTERPOSER_DEFECT_MM2 = 0.0004
INTERPOSER_WAFER_COST = 1937.0        # USD, 65nm 300mm wafer
PKG_SUBSTRATE_COST_PER_MM2 = 0.011    # [5]
PKG_SUBSTRATE_CFP_PER_MM2 = 0.0008
# Assembly cost per chiplet attach/bond event, scaled by the interconnect's
# cost_scale (RDL cheapest ... hybrid bonding most expensive) [5], [44].
ASSEMBLY_COST_PER_CHIPLET = 2.0

# ChipletGym baseline constants (Sec VI-B1/B2): fixed D2D latencies and
# constant bonding yield, energy per MAC only.
CHIPLETGYM_D2D_LATENCY_25D_S = 17.2e-12
CHIPLETGYM_D2D_LATENCY_3D_S = 1.6e-12
CHIPLETGYM_BOND_YIELD = 0.99


# ---------------------------------------------------------------------------
# TechDB — the single object models consume; supports overrides
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TechDB:
    """Bundles every knob; ``overrides`` patches any attribute by name.

    ``TechDB(overrides={"carbon_intensity": 0.1})`` is equivalent to
    passing the field directly but composes with call sites that only
    forward a dict; unknown names raise instead of silently creating
    dead attributes. Recycling fractions are clamped to ``[0, 1]``
    after patching (a credit can neither be negative nor exceed the
    whole material/energy bill)."""

    tech_nodes: Tuple[int, ...] = TECH_NODES
    array_sizes: Tuple[int, ...] = ARRAY_SIZES
    sram_sizes_kb: Mapping[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=lambda: dict(SRAM_SIZES_KB))
    memories: Mapping[str, MemorySpec] = dataclasses.field(
        default_factory=lambda: dict(MEMORIES))
    packages: Mapping[str, PackageSpec] = dataclasses.field(
        default_factory=lambda: dict(PACKAGES))
    protocols: Mapping[str, ProtocolSpec] = dataclasses.field(
        default_factory=lambda: dict(PROTOCOLS))
    array_area_7nm: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(ARRAY_AREA_7NM_MM2))
    array_power_7nm: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(ARRAY_POWER_7NM_W))
    node_area_scale: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_AREA_SCALE))
    node_power_scale: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_POWER_SCALE))
    node_freq_ghz: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_FREQ_GHZ))
    node_cpa: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_CPA_KGCO2_MM2))
    node_defect: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_DEFECT_MM2))
    node_wafer_cost: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_WAFER_COST))
    node_design_cfp: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: dict(NODE_DESIGN_CFP_KGCO2))
    sram_area_per_kb: float = SRAM_AREA_7NM_MM2_PER_KB
    sram_energy_pj_bit_7nm: float = SRAM_ENERGY_PJ_BIT_7NM
    mac_energy_pj_7nm: float = MAC_ENERGY_PJ_7NM
    carbon_intensity: float = CARBON_INTENSITY_KG_PER_KWH
    lifetime_years: float = LIFETIME_YEARS
    use_fraction: float = USE_FRACTION
    production_volume: int = PRODUCTION_VOLUME
    duty_runs_per_s: float = DUTY_RUNS_PER_S
    static_power_fraction: float = STATIC_POWER_FRACTION
    yield_alpha: float = YIELD_CLUSTER_ALPHA
    wafer_diameter_mm: float = WAFER_DIAMETER_MM
    interposer_cpa: float = INTERPOSER_NODE_CPA
    interposer_defect: float = INTERPOSER_DEFECT_MM2
    interposer_wafer_cost: float = INTERPOSER_WAFER_COST
    substrate_cost_mm2: float = PKG_SUBSTRATE_COST_PER_MM2
    substrate_cfp_mm2: float = PKG_SUBSTRATE_CFP_PER_MM2
    assembly_cost: float = ASSEMBLY_COST_PER_CHIPLET
    # lifecycle / regional axes — neutral defaults (see module comment)
    electricity_price: float = ELECTRICITY_PRICE_USD_PER_KWH
    emb_factor: float = EMBODIED_REGION_FACTOR
    grid_profile: Optional[Tuple[float, ...]] = None
    price_profile: Optional[Tuple[float, ...]] = None
    load_profile: Tuple[float, ...] = FLAT_LOAD_PROFILE
    rcy_mat_frac: float = RCY_MAT_FRAC
    rcy_cpa_frac: float = RCY_CPA_FRAC
    wasted_die_scale: float = WASTED_DIE_SCALE
    router_area_frac: float = ROUTER_AREA_FRAC
    noc_hop_latency_s: float = NOC_HOP_LATENCY_S
    noc_energy_pj_bit: float = NOC_ENERGY_PJ_BIT
    overrides: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.overrides:
            field_names = {f.name for f in dataclasses.fields(self)}
            for name, value in self.overrides.items():
                if name == "overrides" or name not in field_names:
                    raise ValueError(f"TechDB has no knob named {name!r}")
                setattr(self, name, value)
        # consumed at construction: a later dataclasses.replace(db, x=...)
        # must not have a stale overrides dict silently undo the change
        self.overrides = None
        # recycling credits are fractions of the bill: clamp to [0, 1]
        self.rcy_mat_frac = min(1.0, max(0.0, float(self.rcy_mat_frac)))
        self.rcy_cpa_frac = min(1.0, max(0.0, float(self.rcy_cpa_frac)))
        for name in ("grid_profile", "price_profile"):
            prof = getattr(self, name)
            if prof is not None:
                prof = tuple(float(x) for x in prof)
                if len(prof) != HOURS_PER_DAY:
                    raise ValueError(
                        f"{name} needs {HOURS_PER_DAY} hourly entries, "
                        f"got {len(prof)}")
                setattr(self, name, prof)
        self.load_profile = tuple(float(x) for x in self.load_profile)
        if len(self.load_profile) != HOURS_PER_DAY:
            raise ValueError(
                f"load_profile needs {HOURS_PER_DAY} hourly entries, "
                f"got {len(self.load_profile)}")
        for size in self.array_sizes:
            if size not in self.sram_sizes_kb:
                raise ValueError(f"no SRAM options for array size {size}")

    # -- convenience lookups used throughout the models --------------------

    def freq_ghz(self, node: int) -> float:
        return self.node_freq_ghz[node]

    def sram_energy_pj_bit(self, node: int) -> float:
        return self.sram_energy_pj_bit_7nm * self.node_power_scale[node]

    def mac_energy_pj(self, node: int) -> float:
        return self.mac_energy_pj_7nm * self.node_power_scale[node]

    def wafer_area_mm2(self) -> float:
        r = self.wafer_diameter_mm / 2.0
        return math.pi * r * r

    def dies_per_wafer(self, die_area_mm2: float) -> int:
        """DPW with edge-loss correction (standard formula, [3]).

        The edge-loss term drives the estimate to zero (and below) as
        the die approaches the wafer — past ``pi r^2 / A =
        pi d / sqrt(2 A)`` (A = r^2/2, i.e. 11250 mm^2 on a 300 mm
        wafer) the formula is meaningless, and silently clamping it to
        "1 die per wafer" would feed garbage into every per-die
        amortization (interposer cost, wasted-die carbon). Such areas
        raise instead; a *positive* fractional estimate below one die
        still clamps to 1 (the die fits, so a wafer yields at least
        one)."""
        if die_area_mm2 <= 0:
            raise ValueError(f"die area must be positive, got {die_area_mm2}")
        r = self.wafer_diameter_mm / 2.0
        dpw = (math.pi * r * r / die_area_mm2
               - math.pi * self.wafer_diameter_mm / math.sqrt(2.0 * die_area_mm2))
        if dpw <= 0.0:
            raise ValueError(
                f"die of {die_area_mm2} mm^2 does not fit a "
                f"{self.wafer_diameter_mm} mm wafer (edge-corrected DPW "
                f"{dpw:.3f} <= 0)")
        return max(1, int(dpw))

    def die_yield(self, die_area_mm2: float, node: int) -> float:
        """Negative binomial yield: (1 + A*D0/alpha)^-alpha [47-49]."""
        d0 = self.node_defect[node]
        a = self.yield_alpha
        return float((1.0 + die_area_mm2 * d0 / a) ** (-a))

    def interposer_yield(self, area_mm2: float) -> float:
        a = self.yield_alpha
        return float((1.0 + area_mm2 * self.interposer_defect / a) ** (-a))

    def uniform_hop_latency(self) -> Optional[float]:
        """The shared per-hop D2D latency if every protocol agrees, else
        ``None``. All three evaluator layers use this to pick the
        bit-pinned ``max_hops * h`` fast path (the default: every stock
        protocol sits at ``DEFAULT_HOP_LATENCY_S``) over the per-kind
        weighted sum needed for heterogeneous hop latencies."""
        lats = {p.hop_latency_s for p in self.protocols.values()}
        return lats.pop() if len(lats) == 1 else None


DEFAULT_DB = TechDB()
