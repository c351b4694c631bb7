"""GPU carbon pathfinder: the counterpart of the JAX package's
``analysis/tpu_pathfinder.py``, for a cluster of GPUs (beyond paper).

CarbonPATH's core move is treating (mapping x architecture x packaging) as
one annealable design vector with carbon as a first-class objective. At
cluster scale the isomorphic vector is:

    chips          <-> chiplets         (how much silicon to light up)
    DP/TP split    <-> interconnect topology
    microbatch     <-> tile sizes       (Algorithm 1's t_M)
    remat          <-> dataflow         (recompute vs hold, OS vs WS)
    grad comp.     <-> protocol choice  (bytes per transferred bit)

The evaluator is the same three-term roofline (compute / HBM /
collective), and the carbon model is ECO-CHIP-style: embodied CFP of the
devices amortized per run + operational CFP from device power x step
time. The annealer, its plan space, its schedule and its use of Python's
``random`` are the JAX package's; the device figures it reads there as
module constants (and a device capacity inline) are fields of a
:class:`PlanHardware` record here. With that package's figures
passed in, :func:`pathfind` returns its plan and metrics bit for bit.
``launch/train.py --pathfind`` prints the result.

:data:`H100_PLAN` is a cluster of H100 SXM boards: 700 W a GPU (its
power limit, as ``nvidia-smi`` reads it), 80 GB, the NVLink domain of an
HGX board (8 GPUs) for the TP term, one 400 Gb/s ConnectX-7 NIC a GPU
across nodes (50e9 B/s; DGX H100 data sheet).

Embodied CFP of one H100 package: no public per-package figure is in
the repository, and the JAX package's figure is for another device. It
is estimated with the port's own ECO-CHIP model
(:func:`repro_torch.core.carbon.chiplet_mfg_cfp` and
``chiplet_design_cfp`` over the default ``TechDB``) for one GH100 die of
814 mm^2 (the H100 whitepaper's figure) at 7 nm, the smallest node of
``core/techdb.py`` (GH100 is built on TSMC 4N, so the node's carbon per
area is an approximation): 94.07 kg. The HBM3 stacks, the CoWoS
interposer and the board are not counted, so it is a lower bound. The
lifetime (4 years at 60 % duty) and the grid intensity (0.475 kg/kWh)
are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Tuple

from repro_torch.analysis.roofline import H100
from repro_torch.configs.base import ModelConfig
from repro_torch.core import carbon
from repro_torch.core.techdb import DEFAULT_DB

GH100_DIE_MM2 = 814.0            # H100 whitepaper
GH100_NODE_NM = 7                # the techdb's smallest node (GH100: 4N)


@dataclasses.dataclass(frozen=True)
class _Die:
    """A die of a given area and node, as ``carbon.chiplet_mfg_cfp`` and
    ``chiplet_design_cfp`` read a chiplet."""
    area: float
    node: int

    def area_mm2(self, db=DEFAULT_DB) -> float:
        return self.area


def h100_embodied_kg() -> float:
    """ECO-CHIP embodied CFP of one GH100 die (module docstring)."""
    die = _Die(GH100_DIE_MM2, GH100_NODE_NM)
    return carbon.chiplet_mfg_cfp(die) + carbon.chiplet_design_cfp(die)


@dataclasses.dataclass(frozen=True)
class PlanHardware:
    """The device and cluster figures :func:`evaluate_plan` reads."""
    peak_flops: float               # per device, the plan's dtype
    hbm_bytes_per_s: float
    link_bytes_per_s: float         # TP links: one link, one direction
    links_active: int
    chip_power_w: float
    chip_embodied_kg: float         # embodied CFP per device package
    chip_lifetime_s: float
    carbon_intensity: float         # kg per J
    dcn_bytes_per_s: float          # per device, across nodes
    hbm_bytes: float                # capacity per device
    tp_max: int                     # widest TP group the TP links join


H100_PLAN = PlanHardware(
    peak_flops=H100.bf16_flops,
    hbm_bytes_per_s=H100.hbm_bytes_per_s,
    link_bytes_per_s=H100.link_bytes_per_s,
    links_active=H100.links_active,
    chip_power_w=700.0,                             # nvidia-smi power.limit
    chip_embodied_kg=h100_embodied_kg(),
    chip_lifetime_s=4 * 365.25 * 86400 * 0.6,       # 4y at 60% duty
    carbon_intensity=0.475 / 3.6e6,                 # kg per J
    dcn_bytes_per_s=50e9,           # 400 Gb/s ConnectX-7 a GPU (DGX H100)
    hbm_bytes=H100.hbm_bytes,
    tp_max=8,                       # NVLink domain of an HGX H100 board
)


@dataclasses.dataclass(frozen=True)
class Plan:
    chips: int                  # total chips (power of 2)
    tp: int                     # model-parallel width (divides chips)
    microbatch: int             # per-device batch
    remat: bool
    compress_grads: bool        # int8 cross-node gradient all-reduce

    @property
    def dp(self) -> int:
        return self.chips // self.tp

    def describe(self) -> str:
        return (f"chips={self.chips} dp={self.dp} tp={self.tp} "
                f"mb={self.microbatch} remat={int(self.remat)} "
                f"int8grads={int(self.compress_grads)}")


@dataclasses.dataclass(frozen=True)
class PlanMetrics:
    step_time_s: float
    energy_j: float
    emb_cfp_kg: float           # amortized per step
    ope_cfp_kg: float           # per step
    hbm_ok: bool

    @property
    def total_cfp(self) -> float:
        return self.emb_cfp_kg + self.ope_cfp_kg


def evaluate_plan(plan: Plan, cfg: ModelConfig, global_batch: int,
                  seq: int, hw: PlanHardware = H100_PLAN) -> PlanMetrics:
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    tokens = global_batch * seq
    # compute term (remat multiplies backward recompute)
    flops = (8.0 if plan.remat else 6.0) * n_active * tokens
    t_compute = flops / (plan.chips * hw.peak_flops * 0.5)  # 50% kernel eff.
    # memory term: params + activations traffic per chip
    param_bytes = 2 * n_total / plan.chips * 3          # read + moments
    act_bytes = tokens / plan.dp * cfg.d_model * 2 * cfg.n_layers
    act_bytes *= (1.0 if plan.remat else 2.0)
    t_mem = (param_bytes + act_bytes) / hw.hbm_bytes_per_s
    # collective term: TP all-reduces + DP gradient reduce
    tp_bytes = 0.0
    if plan.tp > 1:
        tp_bytes = 4 * cfg.n_layers * (tokens / plan.dp) * cfg.d_model * 2
    grad_bytes = 2 * n_active / plan.tp
    if plan.compress_grads:
        grad_bytes /= 4.0                                # int8 + scales
    t_coll = tp_bytes / (plan.chips / plan.dp * hw.link_bytes_per_s
                         * hw.links_active)
    t_coll += grad_bytes / hw.dcn_bytes_per_s if plan.dp > 1 else 0.0
    step = max(t_compute, t_mem) + t_coll                # comms not hidden
    # capacity check: params+moments+activations must fit the device
    act_resident = (tokens / plan.dp / plan.tp * cfg.d_model * 2
                    * (1 if plan.remat else cfg.n_layers))
    hbm = hw.hbm_bytes >= (2 + 8) * n_total / plan.chips + act_resident
    energy = plan.chips * hw.chip_power_w * step
    ope = energy * hw.carbon_intensity
    emb = plan.chips * hw.chip_embodied_kg * (step / hw.chip_lifetime_s)
    return PlanMetrics(step, energy, emb, ope, hbm)


def pathfind(cfg: ModelConfig, global_batch: int, seq: int,
             *, carbon_weight: float = 0.5, iters: int = 4000,
             seed: int = 0, verbose: bool = False,
             hw: PlanHardware = H100_PLAN) -> Tuple[Plan, PlanMetrics]:
    """Anneal (chips, tp, microbatch, remat, compression) minimizing
    step_time + carbon_weight * normalized CFP, rejecting plans that do
    not fit a device. TP widths above ``hw.tp_max`` are not drawn (the
    JAX package's 32 keeps its whole list, so its draws are unchanged)."""
    rng = random.Random(seed)
    chips_opts = [2 ** i for i in range(4, 14)]          # 16..8192
    tp_opts = [t for t in (1, 2, 4, 8, 16, 32) if t <= hw.tp_max]

    def random_plan() -> Plan:
        chips = rng.choice(chips_opts)
        tp = rng.choice([t for t in tp_opts if t <= chips])
        mb = rng.choice([1, 2, 4, 8])
        return Plan(chips, tp, mb, rng.random() < 0.5, rng.random() < 0.5)

    def cost(p: Plan) -> float:
        m = evaluate_plan(p, cfg, global_batch, seq, hw)
        if not m.hbm_ok:
            return float("inf")
        # normalize: seconds plus kg scaled into comparable units
        return m.step_time_s * (1 - carbon_weight) + \
            carbon_weight * m.total_cfp * 50.0

    cur = random_plan()
    while math.isinf(cost(cur)):
        cur = random_plan()
    cur_c = cost(cur)
    best, best_c = cur, cur_c
    t = 1.0
    for i in range(iters):
        cand = random_plan() if rng.random() < 0.3 else dataclasses.replace(
            cur,
            tp=rng.choice([x for x in tp_opts if x <= cur.chips]),
            remat=rng.random() < 0.5,
            compress_grads=rng.random() < 0.5)
        c = cost(cand)
        if c < cur_c or rng.random() < math.exp(-(c - cur_c)
                                                / max(t, 1e-9)):
            cur, cur_c = cand, c
            if c < best_c:
                best, best_c = cand, c
        t *= 0.999
    metrics = evaluate_plan(best, cfg, global_batch, seq, hw)
    if verbose:
        print(f"[pathfind] {best.describe()} step={metrics.step_time_s:.4f}s"
              f" cfp/step={metrics.total_cfp*1e3:.3f}g")
    return best, metrics
