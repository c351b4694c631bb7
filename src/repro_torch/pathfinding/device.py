"""Device-resident pathfinding in torch: fused evaluate+cost, vectorized
moves and the parallel-tempering engine.

The torch counterpart of :mod:`repro.pathfinding.device`. Everything
runs as float64 torch arithmetic on one ``torch.device`` passed in by
the caller (``torch_device``; ``None`` = cuda):

* :class:`DeviceEvaluator` — the fused ``evaluate_cost``: Algorithm-1
  tile assignment (:func:`_assign`), the floorplan / BFS / link topology
  (:func:`_topology`, through the hand-written ``topology`` CUDA kernel
  on the card), the ScaleSim prefix-table gathers
  (:func:`_gather_sims`, through the hand-written ``prefix_select`` CUDA
  kernel on the card), the 13 metrics (:func:`_metrics`) and the Eq. 17
  cost (:func:`_eval_cost`).
* :func:`propose_batch` / :meth:`DeviceEvaluator.propose` — the
  hierarchical move distribution of :func:`repro_torch.core.sa.propose`
  applied to encoded int32 rows, drawn from the threefry stream of
  :mod:`repro_torch.random` so the reference's proposals replay bit for
  bit; candidates that fail :func:`_validity` keep the incumbent row.
* :meth:`DeviceEvaluator.parallel_tempering` — propose, evaluate,
  Metropolis accept and sequential adjacent-pair replica exchange. The
  reference's ``lax.scan`` is a Python loop over sweeps whose carry
  stays on the device, with the same key stream (``split(key, 4)`` per
  sweep), so a seeded search reproduces the reference trajectory.

Numerics: float64 throughout, keeping the reference's operation order
wherever floating-point ties decide a discrete outcome (the floorplan's
greedy accumulation order, Algorithm 1's sorted-order power summation,
stable argsorts, first-index argmax/argmin). Scatters onto permutations
are written as one-hot sums, which are exact and deterministic on CUDA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, random as trandom, resolve_device
from repro_torch.core import comm as comm_mod
from repro_torch.core import schedule as sched_mod
from repro_torch.core.carbon import SECONDS_PER_YEAR
from repro_torch.core.scalesim import OPERAND_BYTES
from repro_torch.core.techdb import DEFAULT_DB, HOURS_PER_DAY, TechDB
from repro_torch.core.templates import Normalizer, Template
from repro_torch.core.workload import DEFAULT_TILE, GEMMWorkload
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.prefix_gather import prefix_select
from repro_torch.kernels.topology.ops import topology
from repro_torch.kernels.topology.ref import _argsort, _first_index
from repro_torch.pathfinding.batch import (
    MetricsBatch,
    _SIM_METRICS,
    get_evaluator,
)
from repro_torch.pathfinding.space import (
    COL_CHIP,
    COL_DATAFLOW,
    COL_MEM,
    COL_N,
    COL_ORDER,
    COL_PAIR25,
    COL_PAIR3,
    COL_SPLITK,
    COL_STACK,
    COL_STYLE,
    DesignSpace,
    S_25D,
    S_2D,
    S_3D,
    S_HYBRID,
)
from repro_torch.runtime import trace

P_APPLICATION = 0.35  # sa.propose's application-level move probability

F64 = torch.float64
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class _Cfg:
    """Static constants of one evaluator (the reference's trace-time
    configuration)."""

    C: int            # max chiplet slots
    W: int            # encoded row width
    A: int            # array-size options
    T_nodes: int      # tech-node options
    S: int            # max SRAM options
    M: int            # memory options
    n_pairs25: int
    n_pairs3: int
    n_pkg25: int
    n_pkg3: int
    L: int            # fixed link slots: C*(C-1)/2 plane + C-1 chain
    T0: int           # tiles without split-K
    T1: int           # tiles with split-K
    wr_bits: float    # wl.M * wl.N * OPERAND_BYTES * 8
    acost: float
    substrate_cost_mm2: float
    substrate_cfp_mm2: float
    interposer_cpa: float
    interposer_defect: float
    interposer_wafer_cost: float
    yield_alpha: float
    wafer_diameter_mm: float
    lifetime_years: float
    use_fraction: float
    duty_runs_per_s: float
    router_area_frac: float           # NoC share of die mfg carbon -> C_HI
    comm: str                         # communication model (core.comm)
    noc_col: int                      # first NoC column (mesh_noc layouts)
    n_mesh: int                       # len(comm.MESH_DIMS)
    n_entry: int                      # len(comm.ENTRY_PLACEMENTS)
    noc_hop_latency_s: float
    noc_energy_pj_bit: float
    # shared per-hop package latency when every protocol agrees (the
    # bit-pinned hops * h form); None switches the hop term to the
    # per-link-kind split using the p25_hl/p3_hl tables
    hop_uniform: Optional[float]
    noc_live: bool                    # NoC axes searchable (not frozen)
    schedule: str                     # schedule model (fixed | window)
    sched_col: int                    # first schedule column (window)
    n_sched: int                      # schedule-shape table rows
    sched_live: bool                  # schedule axes searchable


def _popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for i in range(bits):
        out = out + ((x >> i) & 1)
    return out


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    return _first_index(x == x.amin(dim=-1, keepdim=True))


# ---------------------------------------------------------------------------
# Stage 1: Algorithm 1 tile assignment (port of batch._assign)
# ---------------------------------------------------------------------------


@trace.spanned("pf.assign")
def _assign(powers, nmask, order, total, cfg: _Cfg):
    C = cfg.C
    key = torch.where((order == 0)[:, None], -powers, powers)
    key = torch.where(nmask, key, math.inf)  # padding sorts last either way
    pos = _argsort(key)
    p_sorted = torch.gather(powers, 1, pos)
    # sequential fold in sorted order: equal-power cores make the
    # fractional parts ulp-level ties, so summation order is part of the
    # parity contract with the scalar assigner
    psum = torch.zeros(powers.shape[0], dtype=F64, device=powers.device)
    for c in range(C):
        psum = psum + p_sorted[:, c]
    psum = torch.where(psum > 0, psum, 1.0)
    ideal = p_sorted / psum[:, None] * total.to(F64)[:, None]
    counts = torch.floor(ideal)
    csum = torch.zeros_like(psum)
    for c in range(C):
        csum = csum + counts[:, c]
    remaining = total.to(I64) - csum.to(I64)
    frac = ideal - counts
    frac_pos = _argsort(-frac)
    rank = _argsort(frac_pos)   # exact inverse permutation
    counts_i = counts.to(I64) + (rank < remaining[:, None]).to(I64)
    starts = torch.cat(
        [torch.zeros_like(counts_i[:, :1]),
         torch.cumsum(counts_i[:, :-1], dim=1)], dim=1)
    inv = _argsort(pos)
    start = torch.gather(starts, 1, inv)
    count = torch.gather(counts_i, 1, inv)
    return start, count


# ---------------------------------------------------------------------------
# Stage 2: vectorized topology (slicing floorplan, sorted-BFS routes)
# ---------------------------------------------------------------------------


@trace.spanned("pf.topology")
def _topology(v, areas, tb, cfg: _Cfg):
    """The topology stage: one ``topology`` kernel launch on the card,
    its plain torch version on the CPU (:mod:`repro_torch.kernels.
    topology`)."""
    return topology(v, areas, tb, cfg)


# ---------------------------------------------------------------------------
# Stage 3 + cost: the fused evaluator
# ---------------------------------------------------------------------------


@trace.spanned("pf.gather")
def _gather_sims(v, a_idx, s_idx, di, start, end, tb, cfg: _Cfg, rt=None):
    """Prefix-table gathers for both split-K tables + per-row select.

    The whole stage — both split-K gathers for all five sim metrics, the
    clip to the true tile totals, the split select and the per-slot
    segment reduction — is one :func:`~repro_torch.kernels.
    prefix_gather.prefix_select` call: the ``prefix_select`` CUDA kernel
    on the card, its plain torch version on the CPU.

    ``rt`` (the stacked scenario engine's per-row runtime constants,
    ``[P]`` tensors ``T0``, ``T1``, ``wi``) switches to the
    workload-stacked ``[5, Wk*A*S*3, T_bucket+1]`` tables: rows pick up
    the offset ``wi*A*S*3``, the kernel clips each row at its workload's
    true tile totals, and the ``mn`` rows are read from row ``wi`` of
    the padded ``mn0w``/``mn1w`` clipped at the bucket (``cfg.T0``,
    ``cfg.T1``), as the reference reads them."""
    P = v.shape[0]
    def i32(x):
        return x.to(torch.int32).contiguous()

    rows = (a_idx * cfg.S + s_idx) * 3 + di
    if rt is None:
        p0, p1 = tb["pref0_flat"], tb["pref1_flat"]
        t0v = torch.full((P,), cfg.T0, dtype=torch.int32, device=v.device)
        t1v = torch.full((P,), cfg.T1, dtype=torch.int32, device=v.device)
    else:
        p0, p1 = tb["pref0_flatw"], tb["pref1_flatw"]
        rows = rows + (cfg.A * cfg.S * 3) * rt["wi"][:, None]
        t0v, t1v = i32(rt["T0"]), i32(rt["T1"])
    sel, _ = prefix_select(p0, p1, i32(rows), i32(start), i32(end),
                           i32(v[:, COL_SPLITK]), t0v, t1v)
    sims = {f: sel[..., fi] for fi, f in enumerate(_SIM_METRICS)}
    split1 = (v[:, COL_SPLITK] == 1)[:, None]
    if rt is None:
        mn0 = tb["mn0"][torch.clamp(end, 0, cfg.T0)] - tb["mn0"][
            torch.clamp(start, 0, cfg.T0)]
        mn1 = tb["mn1"][torch.clamp(end, 0, cfg.T1)] - tb["mn1"][
            torch.clamp(start, 0, cfg.T1)]
    else:
        wi = rt["wi"][:, None]
        mn0 = tb["mn0w"][wi, torch.clamp(end, 0, cfg.T0)] - tb["mn0w"][
            wi, torch.clamp(start, 0, cfg.T0)]
        mn1 = tb["mn1w"][wi, torch.clamp(end, 0, cfg.T1)] - tb["mn1w"][
            wi, torch.clamp(start, 0, cfg.T1)]
    mn_bits = torch.where(split1, mn1, mn0)
    return sims, mn_bits


@trace.spanned("pf.slots")
def _slots(v, tb, cfg: _Cfg, rt=None):
    """Per-slot chiplet indices, physicals and the Algorithm-1 tile
    ranges of an encoded population (int64 ``v``); ``rt`` gives each row
    its workload's tile totals (see :func:`_gather_sims`)."""
    C = cfg.C
    P = v.shape[0]
    slot = torch.arange(C, device=v.device)
    n = v[:, COL_N]
    nmask = slot[None, :] < n[:, None]
    chip = v[:, COL_CHIP:COL_CHIP + 3 * C].reshape(P, C, 3)
    a_idx = torch.where(nmask, chip[:, :, 0], 0)
    t_idx = torch.where(nmask, chip[:, :, 1], 0)
    s_idx = torch.where(nmask, chip[:, :, 2], 0)
    cphys = tb["chiplet"][a_idx, t_idx, s_idx]  # [P, C, 4] physicals
    areas = torch.where(nmask, cphys[:, :, 0], 0.0)
    powers = torch.where(nmask, tb["t_power"][a_idx, t_idx], 0.0)
    if rt is None:
        total = torch.where(v[:, COL_SPLITK] == 1, cfg.T1, cfg.T0)
    else:
        total = torch.where(v[:, COL_SPLITK] == 1, rt["T1"], rt["T0"])
    start, count = _assign(powers, nmask, v[:, COL_ORDER], total, cfg)
    return dict(nmask=nmask, a_idx=a_idx, t_idx=t_idx, s_idx=s_idx,
                cphys=cphys, areas=areas, start=start, end=start + count)


@trace.spanned("pf.metrics")
def _metrics(v, tb, cfg: _Cfg, ci, price, embf, profile, pprofile,
             rt=None):
    """The 13 MetricsBatch tensors for an encoded population.

    Mirrors the reference's ``_metrics_jax`` stage by stage. ``ci``
    (grid intensity), ``price`` ($/kWh), ``embf`` (regional embodied
    multiplier), ``profile`` and ``pprofile`` (24h intensity and price
    rows) are runtime tensors; their neutral values (0.0, 1.0,
    flat-at-ci, flat-at-price) reproduce the scalar model bit-for-bit,
    since the corrections ``sum((profile - ci) * load)`` and
    ``sum((pprofile - price) * load)`` are exactly +0.0 for flat rows.
    Each is a scalar, or one value (``[P]``, ``[P, 24]``) per row.
    ``rt`` (``None`` = the cfg constants) carries the stacked scenario
    engine's per-row ``T0``, ``T1``, ``wr_bits`` and workload ``wi``."""
    C = cfg.C
    P = v.shape[0]
    slot = torch.arange(C, device=v.device)
    st = _slots(v, tb, cfg, rt)
    nmask, t_idx, cphys = st["nmask"], st["t_idx"], st["cphys"]
    areas = st["areas"]
    split = v[:, COL_SPLITK]
    di = v[:, COL_DATAFLOW][:, None].expand(P, C)
    sims, mn_bits = _gather_sims(v, st["a_idx"], st["s_idx"], di,
                                 st["start"], st["end"], tb, cfg, rt)

    topo = _topology(v, areas, tb, cfg)
    dest = topo["dest"]

    mask = nmask
    cyc, rd, wr = (sims["cycles"].to(F64), sims["rd"].to(F64),
                   sims["wr"].to(F64))
    sram_b, macs = sims["sram"].to(F64), sims["macs"].to(F64)
    nphys = tb["node"][t_idx]  # [P, C, 4] node-scaled rates
    freq = torch.where(mask, nphys[:, :, 0], 1.0)
    eff_bw = topo["eff_bw"]
    den_bw = torch.where(eff_bw > 0, eff_bw, 1.0)

    # Eq. 5 term 1: max_i (L_compute,i + L_DRAM_RD,i)
    l_comp = cyc / (freq * 1e9)
    l_rd = torch.where(rd > 0, rd / den_bw, 0.0)
    l_cr = torch.amax(l_comp + l_rd, dim=1)

    # Eq. 5 term 2: reduction-phase D2D over shared links (Fig. 4)
    sbits = torch.where(slot[None, :] == dest[:, None], 0.0,
                        mn_bits.to(F64))
    loads = torch.einsum("plc,pc->pl", topo["inc"], sbits)
    l_link = torch.amax(loads / topo["link_bw"], dim=1)
    # per-source path latency: package hops x per-hop latency (uniform
    # latency reproduces the legacy hops * HOP_LATENCY_S program);
    # heterogeneous protocol latencies split the hop count by link kind
    mesh_on = cfg.comm == "mesh_noc"
    if mesh_on:
        nocv = v[:, cfg.noc_col:cfg.noc_col + 2 * C].reshape(P, C, 2)
        mi = torch.where(nmask, nocv[:, :, 0], 0)
        ei = torch.where(nmask, nocv[:, :, 1], 0)
        noc_h = torch.where(nmask, tb["noc_hops"][mi, ei], 0.0)
        noc_r = torch.where(nmask, tb["noc_routers"][mi], 1.0)
    if cfg.hop_uniform is not None:
        path_lat = topo["hops"].to(F64) * cfg.hop_uniform
    else:
        h25 = tb["p25_hl"][torch.clamp(v[:, COL_PAIR25], min=0)]
        h3 = tb["p3_hl"][torch.clamp(v[:, COL_PAIR3], min=0)]
        path_lat = ((topo["hops"] - topo["hops3"]).to(F64) * h25[:, None]
                    + topo["hops3"].to(F64) * h3[:, None])
    if mesh_on:
        # on-chiplet mesh traversal: source egress + destination ingress
        # mean hop counts, per NoC hop latency
        noc_dest = torch.gather(noc_h, 1, dest[:, None])
        pair_noc = noc_h + noc_dest
        path_lat = path_lat + pair_noc * cfg.noc_hop_latency_s
    hop_term = torch.amax(torch.where(sbits > 0, path_lat, 0.0), dim=1)
    l_d2d = l_link + hop_term

    # Eq. 5 term 3: DRAM write-back (split-K dependent)
    eff_dest = torch.gather(eff_bw, 1, dest[:, None])[:, 0]
    wr_split = (cfg.wr_bits if rt is None else rt["wr_bits"]) / eff_dest
    wr_direct = torch.amax(torch.where(wr > 0, wr / den_bw, 0.0), dim=1)
    l_wr = torch.where(split == 1, wr_split, wr_direct)
    latency = l_cr + l_d2d + l_wr

    # energy (Eqs. 12-14)
    mem_idx = torch.clamp(v[:, COL_MEM], 0, cfg.M - 1)
    mrow = tb["mem3"][mem_idx]  # [P, 3]: rd/wr energy + cost
    m_rd = mrow[:, 0][:, None]
    m_wr = mrow[:, 1][:, None]
    sram_e = nphys[:, :, 1]
    mac_e = nphys[:, :, 2]
    e_comp_pj = torch.sum(rd * m_rd + wr * m_wr + sram_b * sram_e
                          + macs * mac_e, dim=1)
    e_mem_d2d_pj = torch.sum((rd + wr) * topo["dram_e"], dim=1)
    e_link_pj = torch.sum(loads * topo["link_e"], dim=1)
    if mesh_on:
        # NoC traversal energy: routed reduction bits x mesh hops x pJ/bit
        e_link_pj = e_link_pj + (torch.sum(sbits * pair_noc, dim=1)
                                 * cfg.noc_energy_pj_bit)
    e_compute_j = e_comp_pj * 1e-12
    e_d2d_j = (e_link_pj + e_mem_d2d_pj) * 1e-12
    static_w = torch.where(mask, cphys[:, :, 1], 0.0)
    e_static_j = torch.sum(static_w, dim=1) * latency
    energy = e_compute_j + e_d2d_j + e_static_j

    # area, dollar cost (Eqs. 15-16)
    area = topo["pkg_area"]
    chip_cost = torch.sum(torch.where(mask, cphys[:, :, 2], 0.0), dim=1)
    icost = torch.where(topo["interp"], _interposer_cost(area, cfg), 0.0)
    package = cfg.substrate_cost_mm2 * area + topo["assembly"]
    bond_y = topo["bond_y"]
    active_s = cfg.lifetime_years * SECONDS_PER_YEAR * cfg.use_fraction
    runs = cfg.duty_runs_per_s * active_s
    # decoded duty weights: window spaces roll the gathered shape row to
    # the per-design start hour; fixed spaces read the shared row 0
    # (= the static load_profile values). Both branches shape the
    # weights [P, 24], so the fixed and window programs reduce the
    # operational products identically (the neutral schedule stays
    # bit-invisible).
    if cfg.schedule == "window":
        sc = cfg.sched_col
        s_start = v[:, sc]
        s_shape = torch.clamp(v[:, sc + 1], 0, cfg.n_sched - 1)
        hrs = torch.arange(HOURS_PER_DAY, device=v.device)
        roll = (hrs[None, :] - s_start[:, None]) % HOURS_PER_DAY
        load = torch.gather(tb["sched_tab"][s_shape], 1, roll)
    else:
        load = tb["sched_tab"][0][None, :].expand(P, HOURS_PER_DAY)
    eff_price = price + torch.sum((pprofile - price[..., None]) * load,
                                  dim=-1)
    dollar = ((chip_cost + icost + package) / bond_y + mrow[:, 2]
              + energy * runs / 3.6e6 * eff_price)

    # embodied + operational CFP (Eqs. 2-3)
    mfg_pc = torch.where(mask, cphys[:, :, 3], 0.0)
    mfg = torch.sum(mfg_pc, dim=1)
    des = torch.sum(torch.where(mask, nphys[:, :, 3], 0.0), dim=1)
    icfp = torch.where(
        topo["interp"],
        area * cfg.interposer_cpa / _nb_yield(
            area, cfg.interposer_defect, cfg.yield_alpha), 0.0)
    pkg_cfp_multi = (cfg.substrate_cfp_mm2 * area
                     + topo["p25_rate"] * area + icfp
                     + topo["p3_bonded"]) / bond_y
    pkg_cfp = torch.where(topo["is2d"], cfg.substrate_cfp_mm2 * area,
                          pkg_cfp_multi)
    if mesh_on:
        # router carbon scales with each die's physical router count
        # (mx * my) instead of the flat per-die share
        pkg_cfp = pkg_cfp + cfg.router_area_frac * torch.sum(
            mfg_pc * noc_r, dim=1)
    else:
        pkg_cfp = pkg_cfp + cfg.router_area_frac * mfg
    emb = (mfg + des + pkg_cfp) * embf
    eff_ci = ci + torch.sum((profile - ci[..., None]) * load, dim=-1)
    ope = energy * runs / 3.6e6 * eff_ci

    return (latency, energy, area, dollar, emb, ope, l_cr, l_d2d, l_wr,
            e_compute_j, e_d2d_j, torch.sum(loads, dim=1),
            torch.sum(macs, dim=1))


def _interposer_cost(area, cfg: _Cfg):
    r = cfg.wafer_diameter_mm / 2.0
    dpw = (math.pi * r * r / area
           - math.pi * cfg.wafer_diameter_mm / torch.sqrt(2.0 * area))
    dpw = torch.clamp(torch.trunc(dpw), min=1.0)
    y = _nb_yield(area, cfg.interposer_defect, cfg.yield_alpha)
    return cfg.interposer_wafer_cost / dpw / y


def _nb_yield(area, d0: float, alpha: float):
    return (1.0 + area * d0 / alpha) ** (-alpha)


@trace.spanned("pf.evaluate")
def _eval_cost(v, mins, medians, w, ci, price, embf, profile, pprofile,
               tb, cfg: _Cfg, rt=None):
    """Fused metrics + Eq. 17 cost (METRIC_FIELDS column order) + the
    ``OBJECTIVE_AXES`` vector ``(latency_s, dollar, total_cfp)``.

    ``w``, ``mins`` and ``medians`` are ``[6]`` rows or per-row
    ``[P, 6]`` matrices; ``rt`` as in :func:`_metrics`."""
    mets = _metrics(v, tb, cfg, ci, price, embf, profile, pprofile, rt)
    x = torch.stack([mets[1], mets[2], mets[0], mets[3], mets[4], mets[5]],
                    dim=1)
    cost = ((x - mins) / medians * torch.atleast_2d(w)).sum(dim=1)
    vec = torch.stack([mets[0], mets[3], mets[4] + mets[5]], dim=1)
    return mets, cost, vec


# ---------------------------------------------------------------------------
# Vectorized hierarchical moves (device rendering of sa.propose)
# ---------------------------------------------------------------------------


@trace.spanned("pf.validity")
def _validity(v, tb, cfg: _Cfg):
    """Torch port of :meth:`DesignSpace.validity_mask` (int64 ``v``)."""
    C = cfg.C
    n = v[:, COL_N]
    style = v[:, COL_STYLE]
    p25, p3, stck = v[:, COL_PAIR25], v[:, COL_PAIR3], v[:, COL_STACK]
    ok = (n >= 1) & (n <= C)
    ok &= (style >= 0) & (style < 4)
    ok &= (v[:, COL_MEM] >= 0) & (v[:, COL_MEM] < cfg.M)
    ok &= (v[:, COL_ORDER] >= 0) & (v[:, COL_ORDER] <= 1)
    ok &= (v[:, COL_DATAFLOW] >= 0) & (v[:, COL_DATAFLOW] < 3)
    ok &= (v[:, COL_SPLITK] >= 0) & (v[:, COL_SPLITK] <= 1)
    chip = v[:, COL_CHIP:COL_CHIP + 3 * C].reshape(-1, C, 3)
    active = torch.arange(C, device=v.device)[None, :] < n[:, None]
    a, t, s = chip[:, :, 0], chip[:, :, 1], chip[:, :, 2]
    a_ok = (a >= 0) & (a < cfg.A)
    chip_ok = (a_ok & (t >= 0) & (t < cfg.T_nodes) & (s >= 0)
               & (s < tb["n_sram"][torch.where(a_ok, a, 0)]))
    ok &= (chip_ok | ~active).all(dim=1)
    if cfg.comm == "mesh_noc":
        nocv = v[:, cfg.noc_col:cfg.noc_col + 2 * C].reshape(-1, C, 2)
        mi, ei = nocv[:, :, 0], nocv[:, :, 1]
        noc_ok = ((mi >= 0) & (mi < cfg.n_mesh)
                  & (ei >= 0) & (ei < cfg.n_entry))
        ok &= (noc_ok | ~active).all(dim=1)
    if cfg.schedule == "window":
        st_ = v[:, cfg.sched_col]
        sh_ = v[:, cfg.sched_col + 1]
        ok &= ((st_ >= 0) & (st_ < HOURS_PER_DAY)
               & (sh_ >= 0) & (sh_ < cfg.n_sched))
    pc = _popcount(stck, C)
    no3d, no25, nostk = p3 == -1, p25 == -1, stck == 0
    has25 = (p25 >= 0) & (p25 < cfg.n_pairs25)
    has3 = (p3 >= 0) & (p3 < cfg.n_pairs3)
    in_range = stck < (1 << torch.clamp(n, max=30))
    ok &= torch.where(style == S_2D, (n == 1) & no25 & no3d & nostk, True)
    ok &= torch.where(style == S_25D, (n >= 2) & has25 & no3d & nostk, True)
    ok &= torch.where(style == S_3D, (n >= 2) & has3 & no25 & nostk, True)
    ok &= torch.where(style == S_HYBRID,
                      (n >= 3) & has25 & has3 & (pc >= 2) & (pc < n)
                      & in_range & (stck >= 0), True)
    return ok


def _draws(key, rows: int, P: int) -> torch.Tensor:
    """``[rows, P]`` uniforms for P population rows. A ``[2]`` key draws
    ``uniform(key, (rows, P))``; a ``[S, 2]`` batch draws ``(rows, P //
    S)`` per key, so population row p of cell ``p // (P // S)`` reads its
    own key's draws."""
    if key.dim() == 1:
        return trandom.uniform(key, (rows, P))
    return trandom.uniform_cells(key, rows, P // key.shape[0])


@trace.spanned("pf.propose")
def _propose(key, v, tb, cfg: _Cfg, noc_on=None, sched_on=None):
    """One hierarchical move per encoded row (int64 ``v``), mirroring the
    level/branch distribution of :func:`repro_torch.core.sa.propose`.

    Every draw of the sweep comes from one threefry pass
    (``uniform(key, (31 + C, P))``: row i is the i-th logical stream,
    uniform ints are ``floor(u * m)``); the mesh-NoC and window-schedule
    levels read their own ``fold_in(key, 7)`` / ``fold_in(key, 8)``
    side-streams, so the legacy draws are the same whichever levels
    exist. Chiplet redraw-until-different uses two resamples. Rows whose
    candidate fails validity keep the incumbent.

    ``key`` is one ``[2]`` key, or a ``[S, 2]`` batch whose cell s owns
    the s-th block of ``P // S`` rows (the stacked scenario engine). The
    NoC / schedule move gates ``noc_on`` / ``sched_on`` are per-row
    float tensors of 0.0 / 1.0, or ``None`` for the space's own
    liveness."""
    C = cfg.C
    P = v.shape[0]
    dev = v.device
    slot = torch.arange(C, device=dev)
    mesh = cfg.comm == "mesh_noc"
    win = cfg.schedule == "window"
    U = _draws(key, 31 + C, P)

    def uni(i):
        return U[i]

    def ri(i, maxv):
        return torch.floor(U[i] * maxv).to(I64)

    n = v[:, COL_N]
    style = v[:, COL_STYLE]
    mem = v[:, COL_MEM]
    order = v[:, COL_ORDER]
    df = v[:, COL_DATAFLOW]
    sk = v[:, COL_SPLITK]
    p25 = v[:, COL_PAIR25]
    p3 = v[:, COL_PAIR3]
    stck = v[:, COL_STACK]
    chip = v[:, COL_CHIP:COL_CHIP + 3 * C].reshape(P, C, 3)

    # -- application level: dataflow | split-K | order ----------------------
    which = ri(0, 3)
    cand_app = v.clone()
    cand_app[:, COL_DATAFLOW] = torch.where(which == 0,
                                            (df + 1 + ri(1, 2)) % 3, df)
    cand_app[:, COL_SPLITK] = torch.where(which == 1, 1 - sk, sk)
    cand_app[:, COL_ORDER] = torch.where(which == 2, 1 - order, order)

    # -- memory move --------------------------------------------------------
    cand_mem = v.clone()
    cand_mem[:, COL_MEM] = (mem + 1 + ri(2, cfg.M - 1)) % cfg.M

    # -- chiplet replacement ------------------------------------------------
    def draw_chiplet(ia, it, iu):
        a = ri(ia, cfg.A)
        t = ri(it, cfg.T_nodes)
        s = torch.floor(uni(iu) * tb["n_sram"][a].to(F64)).to(I64)
        return torch.stack([a, t, s], dim=1)

    r_rep = torch.floor(uni(3) * n.to(F64)).to(I64)
    old = torch.gather(chip, 1, r_rep[:, None, None].expand(P, 1, 3))[:, 0]
    new = draw_chiplet(4, 5, 6)
    for ia, it, iu in ((7, 8, 9), (10, 11, 12)):
        new = torch.where((new == old).all(dim=1)[:, None],
                          draw_chiplet(ia, it, iu), new)
    chip_rep = torch.where(slot[None, :, None] == r_rep[:, None, None],
                           new[:, None, :], chip)
    cand_rep = v.clone()
    cand_rep[:, COL_CHIP:COL_CHIP + 3 * C] = chip_rep.reshape(P, -1)

    # -- chip-architecture: grow / shrink + dynamic HI-type repair ----------
    dlt = torch.where(uni(13) < 0.5, -1, 1)
    n2a = torch.clamp(n + dlt, 1, C)
    n2 = torch.where(n2a == n, torch.clamp(n - dlt, 1, C), n2a)
    grow = n2 > n
    r_del = torch.floor(uni(14) * n.to(F64)).to(I64)
    idx_shift = torch.clamp(
        slot[None, :] + (slot[None, :] >= r_del[:, None]).to(I64), max=C - 1)
    chip_shr = torch.gather(chip, 1, idx_shift[:, :, None].expand(P, C, 3))
    chip_grow = torch.where(slot[None, :, None] == n[:, None, None],
                            draw_chiplet(15, 16, 17)[:, None, :], chip)
    chip_gs = torch.where(grow[:, None, None], chip_grow, chip_shr)
    chip_gs = torch.where((slot[None, :] < n2[:, None])[:, :, None],
                          chip_gs, -1)
    style2 = torch.where(
        n2 == 1, S_2D,
        torch.where((n2 == 2) & (style == S_HYBRID), S_3D,
                    torch.where((n2 >= 2) & (style == S_2D), S_25D, style)))
    need25 = (style2 == S_25D) | (style2 == S_HYBRID)
    need3 = (style2 == S_3D) | (style2 == S_HYBRID)
    pkg_d = ri(18, cfg.n_pkg25)
    pr_d = torch.floor(
        uni(19) * tb["p25_cnt"][pkg_d].to(F64)).to(I64)
    pair25_draw = tb["p25_flat"][tb["p25_off"][pkg_d] + pr_d]
    pair3_draw = tb["pair3_of_pkg"][ri(20, cfg.n_pkg3)]
    p25_2 = torch.where(need25, torch.where(p25 < 0, pair25_draw, p25), -1)
    p3_2 = torch.where(need3, torch.where(p3 < 0, pair3_draw, p3), -1)
    keep = stck & ((1 << n2) - 1)
    pc = _popcount(keep, C)
    bad = (pc < 2) | (pc >= n2)
    size = torch.where(
        n2 > 2,
        2 + torch.floor(uni(21) * (n2 - 2).to(F64)).to(I64), 2)
    scores = torch.where(slot[None, :] < n2[:, None],
                         U[31:31 + C].T, math.inf)
    rank = _argsort(_argsort(scores))
    mask_new = torch.sum((rank < size[:, None]).to(I64) << slot[None, :],
                         dim=1)
    stack2 = torch.where(style2 == S_HYBRID,
                         torch.where(bad, mask_new, keep), 0)
    head = torch.stack([n2, style2, mem, order, df, sk, p25_2, p3_2, stack2],
                       dim=1)
    gs_parts = [head, chip_gs.reshape(P, -1)]
    if mesh:
        # mirror the chiplet-slot shift/append on the NoC columns: grown
        # slots seed the neutral (1x1, corner) = (0, 0) pair
        noc = v[:, cfg.noc_col:cfg.noc_col + 2 * C].reshape(P, C, 2)
        noc_shr = torch.gather(noc, 1,
                               idx_shift[:, :, None].expand(P, C, 2))
        noc_grow = torch.where(slot[None, :, None] == n[:, None, None],
                               0, noc)
        noc_gs = torch.where(grow[:, None, None], noc_grow, noc_shr)
        noc_gs = torch.where((slot[None, :] < n2[:, None])[:, :, None],
                             noc_gs, -1)
        gs_parts.append(noc_gs.reshape(P, -1))
    if win:
        # whole-design schedule columns ride through grow/shrink intact
        gs_parts.append(v[:, cfg.sched_col:cfg.sched_col + 2])
    cand_gs = torch.cat(gs_parts, dim=1)

    # -- package level ------------------------------------------------------
    p25c = torch.clamp(p25, min=0)
    cur_pkg25 = tb["pair25_pkg"][p25c]
    new_pkg25 = (cur_pkg25 + 1 + ri(23, cfg.n_pkg25 - 1)) % cfg.n_pkg25
    kept = tb["pair25_by_pkg_proto"][new_pkg25, tb["pair25_proto"][p25c]]
    cnt_np = tb["p25_cnt"][new_pkg25]
    rnd_pair = tb["p25_flat"][
        tb["p25_off"][new_pkg25]
        + torch.floor(uni(24) * cnt_np.to(F64)).to(I64)]
    pkg25_res = torch.where(kept >= 0, kept, rnd_pair)
    cnt_cur = tb["p25_cnt"][cur_pkg25]
    others = cnt_cur - 1
    loc = tb["pair25_local"][p25c]
    j_o = torch.floor(
        uni(25) * torch.clamp(others, min=1).to(F64)).to(I64)
    proto25_res = tb["p25_flat"][
        tb["p25_off"][cur_pkg25]
        + (loc + 1 + j_o) % torch.clamp(cnt_cur, min=1)]
    cur_pkg3 = tb["pair3_pkg"][torch.clamp(p3, min=0)]
    pkg3_res = tb["pair3_of_pkg"][
        (cur_pkg3 + 1 + ri(26, cfg.n_pkg3 - 1)) % cfg.n_pkg3]
    n_opts = torch.where(style == S_25D, 2,
                         torch.where(style == S_HYBRID, 3, 1))
    pick = torch.floor(uni(27) * n_opts.to(F64)).to(I64)
    has_plane = (style == S_25D) | (style == S_HYBRID)
    sel_pkg25 = has_plane & (pick == 0)
    sel_proto25 = has_plane & (pick == 1) & (others > 0)
    sel_pkg3 = (style == S_3D) | ((style == S_HYBRID) & (pick == 2))
    cand_pkg = v.clone()
    cand_pkg[:, COL_PAIR25] = torch.where(
        sel_pkg25, pkg25_res, torch.where(sel_proto25, proto25_res, p25))
    cand_pkg[:, COL_PAIR3] = torch.where(sel_pkg3, pkg3_res, p3)

    # -- NoC level: redraw one chiplet's (mesh dims, entry) pair ------------
    if mesh:
        Un = _draws(trandom.fold_in(key, 7), 5, P)
        r_noc = torch.floor(Un[0] * n.to(F64)).to(I64)

        def draw_noc(im, ie):
            m_ = torch.floor(Un[im] * cfg.n_mesh).to(I64)
            e_ = torch.floor(Un[ie] * cfg.n_entry).to(I64)
            return torch.stack([m_, e_], dim=1)

        old_noc = torch.gather(noc, 1,
                               r_noc[:, None, None].expand(P, 1, 2))[:, 0]
        new_noc = draw_noc(1, 2)
        new_noc = torch.where((new_noc == old_noc).all(dim=1)[:, None],
                              draw_noc(3, 4), new_noc)
        noc_mv = torch.where(slot[None, :, None] == r_noc[:, None, None],
                             new_noc[:, None, :], noc)
        cand_noc = v.clone()
        cand_noc[:, cfg.noc_col:cfg.noc_col + 2 * C] = noc_mv.reshape(P, -1)

    # -- schedule level: nudge start hour or redraw the window shape --------
    if win:
        Us = _draws(trandom.fold_in(key, 8), 3, P)
        sc = cfg.sched_col
        s_start = v[:, sc]
        s_shape = v[:, sc + 1]
        start2 = (s_start + 1 + torch.floor(
            Us[1] * (HOURS_PER_DAY - 1)).to(I64)) % HOURS_PER_DAY
        shape2 = (s_shape + 1 + torch.floor(
            Us[2] * (cfg.n_sched - 1)).to(I64)) % cfg.n_sched
        s_coin = Us[0] < 0.5  # start-hour nudge vs shape redraw
        cand_sched = v.clone()
        cand_sched[:, sc] = torch.where(s_coin, start2, s_start)
        cand_sched[:, sc + 1] = torch.where(s_coin, s_shape, shape2)

    # -- hierarchical branch selection + validity gate ----------------------
    is_app = uni(28) < P_APPLICATION
    coin = uni(30)
    if mesh or win:
        # live axes widen the uniform level draw from 3 to up to 5
        # options; floor(u * 3.0) is the legacy ri(29, 3) exactly, so
        # frozen-axis spaces replay the 3-level distribution
        noc_on_f = (((1.0 if cfg.noc_live else 0.0) if noc_on is None
                     else noc_on) if mesh else None)
        sched_on_f = (((1.0 if cfg.sched_live else 0.0) if sched_on is None
                       else sched_on) if win else None)
        n_levels = 3.0
        if mesh:
            n_levels = n_levels + noc_on_f
        if win:
            n_levels = n_levels + sched_on_f
        level = torch.floor(U[29] * n_levels).to(I64)
        if mesh and win:
            # the schedule level sits after the NoC level iff NoC moves
            # are on
            if noc_on is None:
                is_noc = (level == 3) & (int(noc_on_f) == 1)
            else:
                is_noc = (level == 3) & (torch.floor(noc_on_f) == 1)
            lower = torch.where(
                (level == 1)[:, None], cand_rep,
                torch.where((level == 2)[:, None], cand_pkg,
                            torch.where(is_noc[:, None], cand_noc,
                                        cand_sched)))
        elif mesh:
            lower = torch.where(
                (level == 1)[:, None], cand_rep,
                torch.where((level == 2)[:, None], cand_pkg, cand_noc))
        else:
            lower = torch.where(
                (level == 1)[:, None], cand_rep,
                torch.where((level == 2)[:, None], cand_pkg, cand_sched))
    else:
        level = ri(29, 3)
        lower = torch.where((level == 1)[:, None], cand_rep, cand_pkg)
    cand = torch.where(
        is_app[:, None], cand_app,
        torch.where((level == 0)[:, None],
                    torch.where((coin < 0.5)[:, None], cand_gs, cand_mem),
                    lower))
    ok = _validity(cand, tb, cfg)
    return torch.where(ok[:, None], cand, v)


@trace.spanned("pf.exchange")
def _exchange(v, costs, inv_t, us, pair_ok=None):
    """Sequential adjacent-pair replica exchange of S independent cells,
    in place on the device tensors ``v`` ``[S, n, W]`` / ``costs``
    ``[S, n]`` (``inv_t`` ``[S, n]``, ``us`` ``[S, n-1]``). Pair step j
    updates column j of every cell at once, so the kernel count does not
    grow with S. ``d >= 0`` short-circuits in the host reference, so
    only exp of non-positive ``d`` is compared; ``pair_ok[s, j]`` gates
    the pair (j, j+1) of cell s (independent ladders, cells that do not
    swap this sweep). With no mask every pair may swap, and the loop
    adds no gating op."""
    trace.count("exchange_rounds")
    for j in range(costs.shape[1] - 1):
        c_i, c_j = costs[:, j].clone(), costs[:, j + 1].clone()
        d = (inv_t[:, j] - inv_t[:, j + 1]) * (c_i - c_j)
        sw = (d >= 0) | (us[:, j] < torch.exp(torch.clamp(d, max=0.0)))
        if pair_ok is not None:
            sw = sw & pair_ok[:, j]
        costs[:, j] = torch.where(sw, c_j, c_i)
        costs[:, j + 1] = torch.where(sw, c_i, c_j)
        v_i, v_j = v[:, j].clone(), v[:, j + 1].clone()
        v[:, j] = torch.where(sw[:, None], v_j, v_i)
        v[:, j + 1] = torch.where(sw[:, None], v_i, v_j)


# ---------------------------------------------------------------------------
# Shared table/cfg builders
# ---------------------------------------------------------------------------


def _base_cfg(sp: DesignSpace, db: TechDB, T0: int, T1: int,
              wr_bits: float) -> _Cfg:
    """The static constants of one (TechDB, DesignSpace, workload)."""
    return _Cfg(
        C=sp.max_chiplets, W=sp.width, A=len(sp.arrays),
        T_nodes=len(sp.nodes), S=int(sp.n_sram.max()),
        M=len(sp.memories), n_pairs25=len(sp.pairs_25d),
        n_pairs3=len(sp.pairs_3d),
        n_pkg25=len(sp.pkg25_pairs), n_pkg3=len(sp.pkg3_pairs),
        L=sp.max_chiplets * (sp.max_chiplets - 1) // 2
        + sp.max_chiplets - 1,
        T0=T0, T1=T1, wr_bits=wr_bits,
        acost=db.assembly_cost,
        substrate_cost_mm2=db.substrate_cost_mm2,
        substrate_cfp_mm2=db.substrate_cfp_mm2,
        interposer_cpa=db.interposer_cpa,
        interposer_defect=db.interposer_defect,
        interposer_wafer_cost=db.interposer_wafer_cost,
        yield_alpha=db.yield_alpha,
        wafer_diameter_mm=db.wafer_diameter_mm,
        lifetime_years=db.lifetime_years,
        use_fraction=db.use_fraction,
        duty_runs_per_s=db.duty_runs_per_s,
        router_area_frac=db.router_area_frac,
        comm=sp.comm,
        noc_col=sp.noc_col,
        n_mesh=len(comm_mod.MESH_DIMS),
        n_entry=len(comm_mod.ENTRY_PLACEMENTS),
        noc_hop_latency_s=db.noc_hop_latency_s,
        noc_energy_pj_bit=db.noc_energy_pj_bit,
        hop_uniform=db.uniform_hop_latency(),
        noc_live=sp.noc_live,
        schedule=sp.schedule,
        sched_col=sp.sched_col if sp.schedule == "window" else -1,
        n_sched=sched_mod.n_schedule_shapes(),
        sched_live=sp.sched_live,
    )


def _shared_tables(host, sp: DesignSpace, dev: torch.device) -> dict:
    """Workload-independent tables (chiplet physicals, node rates,
    memory energies, package info, move tables) on ``dev``. Integer
    tables are int64 so they index directly."""
    mt = sp.move_tables()
    noc_h, noc_r = comm_mod.noc_tables()

    def f8(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=dev)

    def i8(x):
        return torch.tensor(np.asarray(x, dtype=np.int64), device=dev)

    return dict(
        # per-chiplet physicals / node rates / memory energies are
        # stacked along a trailing axis: one gather per site
        chiplet=f8(np.stack(
            [host.t_area, host.t_static, host.t_cost, host.t_mfg], axis=-1)),
        node=f8(np.stack(
            [host.t_freq, host.t_sram_e, host.t_mac_e, host.t_des], axis=-1)),
        mem3=f8(np.stack([host.m_rd, host.m_wr, host.m_cost], axis=-1)),
        t_power=f8(host.t_power),
        m_bw=f8(host.m_bw),
        p25=f8([i[:7] for i in host.p25_info]),
        p25_interp=torch.as_tensor(
            np.asarray([i[7] for i in host.p25_info], dtype=bool),
            device=dev),
        p3=f8([i[:7] for i in host.p3_info]),
        p25_hl=f8(host.p25_hl),
        p3_hl=f8(host.p3_hl),
        noc_hops=f8(noc_h),
        noc_routers=f8(noc_r),
        # duty-weight shape table (row 0 = db.load_profile verbatim)
        sched_tab=f8(sched_mod.schedule_tables(host.db)),
        n_sram=i8(sp.n_sram),
        **{k: i8(a) for k, a in mt.items()},
    )


def _tile_tables(host, dev: torch.device) -> dict:
    """Per-workload prefix-sum tables: the int64 ``[5, A*S*3, T+1]``
    stacks the gather kernel reads (one plane per sim metric, row
    ``(a*S + s)*3 + dataflow``) and the ``mn`` prefix rows."""
    out = {}
    for sk, name in ((0, "pref0_flat"), (1, "pref1_flat")):
        pref = np.stack([host.tiles[sk]["pref"][f] for f in _SIM_METRICS])
        out[name] = torch.as_tensor(
            np.ascontiguousarray(
                pref.reshape(len(_SIM_METRICS), -1, pref.shape[-1])),
            device=dev)
    out["mn0"] = torch.as_tensor(host.tiles[0]["mn_pref"], device=dev)
    out["mn1"] = torch.as_tensor(host.tiles[1]["mn_pref"], device=dev)
    return out


# ---------------------------------------------------------------------------
# The device evaluator + tempering engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DevicePTResult:
    """Output of the parallel-tempering engine (host arrays)."""

    best_enc: np.ndarray          # encoded best row
    best_cost: float
    history: List[float]          # [initial best] + coldest-chain per sweep
    evaluations: int
    final_enc: np.ndarray         # [n_chains, width] final population
    final_costs: np.ndarray
    # per-sweep host-replay state (``record_trace=True``): proposals,
    # proposal_costs, u_accept, u_swap, accepted, costs (after the
    # exchange), best_per_sweep, plus the seed population's initial_costs
    trace: Optional[Dict[str, np.ndarray]] = None
    # every evaluated design + its OBJECTIVE_AXES vector (seed population
    # first): enc [1 + sweeps, n, width], vec [1 + sweeps, n, 3] — the
    # Pareto archive's input when no archive is passed
    samples: Optional[Dict[str, np.ndarray]] = None


# trailing shapes of the trace fields, for the empty (zero-sweep) trace
_TRACE_TAILS = (
    lambda n, w: (n, w),             # proposals
    lambda n, w: (n,),               # proposal_costs
    lambda n, w: (n,),               # u_accept
    lambda n, w: (max(n - 1, 1),),   # u_swap
    lambda n, w: (n,),               # accepted
    lambda n, w: (n,),               # costs
    lambda n, w: (),                 # best_per_sweep
)
_TRACE_FIELDS = ("proposals", "proposal_costs", "u_accept", "u_swap",
                 "accepted", "costs", "best_per_sweep")


def _db_region_cols(db: TechDB) -> Tuple[np.float64, np.float64,
                                         np.ndarray, np.ndarray]:
    """The (price, embf, profile, pprofile) runtime region columns a
    single-region evaluator synthesizes from its TechDB. A ``None`` grid
    (price) profile becomes the flat row at ``carbon_intensity``
    (``electricity_price``), so the default columns are bit-neutral."""
    price = np.float64(db.electricity_price)
    embf = np.float64(db.emb_factor)
    if db.grid_profile is None:
        profile = np.full(len(db.load_profile),
                          np.float64(db.carbon_intensity))
    else:
        profile = np.asarray(db.grid_profile, dtype=np.float64)
    if db.price_profile is None:
        pprofile = np.full(len(db.load_profile), price)
    else:
        pprofile = np.asarray(db.price_profile, dtype=np.float64)
    return price, embf, profile, pprofile


class DeviceEvaluator:
    """Fused evaluate+cost and tempering engine for one workload on one
    torch device.

    Reuses the host :class:`~repro_torch.pathfinding.batch.
    BatchEvaluator`'s numpy tables (chiplet physicals, tile prefix sums,
    package info), copied once to ``torch_device`` (``None`` = cuda)."""

    def __init__(self, wl: GEMMWorkload, db: TechDB = DEFAULT_DB,
                 tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
                 space: Optional[DesignSpace] = None,
                 torch_device: DeviceLike = None):
        self.device = resolve_device(torch_device)
        self.wl, self.db, self.tile_sizes = wl, db, tile_sizes
        host = get_evaluator(wl, db, tile_sizes, space)
        self.host = host
        self.space = host.space
        self.cfg = _base_cfg(
            self.space, db, T0=host.tiles[0]["T"], T1=host.tiles[1]["T"],
            wr_bits=float(wl.M * wl.N * OPERAND_BYTES * 8))
        self.tables = {**_shared_tables(host, self.space, self.device),
                       **_tile_tables(host, self.device)}

    def _t(self, x, dtype=F64) -> torch.Tensor:
        with trace.synced("upload"):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

    def _enc(self, encoded) -> torch.Tensor:
        v = np.atleast_2d(np.asarray(encoded, dtype=np.int32))
        with trace.synced("upload"):
            return torch.as_tensor(v.astype(np.int64), device=self.device)

    def _region(self):
        price, embf, profile, pprofile = _db_region_cols(self.db)
        return (self._t(np.float64(self.db.carbon_intensity)),
                self._t(price), self._t(embf), self._t(profile),
                self._t(pprofile))

    def evaluate_cost(self, encoded: np.ndarray, norm: Normalizer,
                      template: Template
                      ) -> Tuple[MetricsBatch, np.ndarray]:
        """Fused metrics + Eq. 17 cost for an encoded population."""
        mb, cost, _ = self.evaluate_cost_vector(encoded, norm, template)
        return mb, cost

    def evaluate_cost_vector(self, encoded: np.ndarray, norm: Normalizer,
                             template: Template
                             ) -> Tuple[MetricsBatch, np.ndarray,
                                        np.ndarray]:
        """Fused metrics + cost + ``(latency, dollar, total_cfp)``
        vectors."""
        mins, medians = norm.weights_arrays()
        mets, cost, vec = _eval_cost(
            self._enc(encoded), self._t(mins), self._t(medians),
            self._t(np.asarray(template.weights, dtype=np.float64)),
            *self._region(), self.tables, self.cfg)
        return (MetricsBatch(*[trace.fetch(m, "result").numpy()
                               for m in mets]),
                trace.fetch(cost, "result").numpy(),
                trace.fetch(vec, "result").numpy())

    def metrics(self, encoded: np.ndarray) -> MetricsBatch:
        """Raw metrics through the fused path (identity normalizer)."""
        from repro_torch.core.templates import IDENTITY_NORMALIZER, TEMPLATES

        return self.evaluate_cost(encoded, IDENTITY_NORMALIZER,
                                  TEMPLATES["T1"])[0]

    def propose(self, encoded: np.ndarray, seed: int = 0) -> np.ndarray:
        """One vectorized hierarchical move per row (valid rows only)."""
        out = _propose(trandom.PRNGKey(seed, self.device),
                       self._enc(encoded), self.tables, self.cfg)
        return trace.fetch(out.to(torch.int32), "result").numpy()

    @trace.spanned("pf.engine")
    def parallel_tempering(self, v0: np.ndarray, temps, sweeps: int,
                           swap_every: int, seed: int, norm: Normalizer,
                           template: Template,
                           record_trace: bool = False,
                           weights: Optional[np.ndarray] = None,
                           pair_mask: Optional[np.ndarray] = None,
                           collect_samples: bool = True,
                           segment: Optional[int] = None,
                           checkpoint=None, resume: bool = True,
                           archive=None) -> DevicePTResult:
        """Run the propose/evaluate/accept/exchange loop.

        ``v0`` is the encoded seed population (one row per chain, coldest
        chain last); ``temps`` the matching temperature ladder.

        ``weights`` (``[n, 6]``) gives every chain its own Eq. 17
        scalarization row (default: ``template.weights`` for all) and
        ``pair_mask`` (``[max(n-1, 1)]`` bool) disables replica exchange
        across selected adjacent pairs — together they run K independent
        scalarization ladders in one loop (the
        :class:`~repro_torch.pathfinding.pareto.ScalarizationSweep`
        engine). ``record_trace`` returns the per-sweep host-replay state
        in ``.trace``.

        ``collect_samples`` keeps every evaluated design + objective
        vector; with ``archive`` (a :class:`~repro_torch.pathfinding.
        pareto.ParetoArchive`) they feed it at each segment boundary,
        otherwise they return in ``.samples``. ``segment`` cuts the
        sweeps into chunks of that many (default: one chunk) without
        changing the trajectory. ``checkpoint`` (a
        :class:`~repro_torch.pathfinding.resume.SearchCheckpointer`)
        snapshots carry + archive + history at every boundary; with
        ``resume=True`` the newest snapshot of this search is restored
        and the run continues to ``sweeps`` (``record_trace`` cannot be
        combined with checkpointing). The loop itself is
        :func:`~repro_torch.pathfinding.resume.run_segmented`."""
        from repro_torch.pathfinding.resume import (
            run_segmented,
            segment_fingerprint,
        )

        v0 = np.atleast_2d(np.asarray(v0, dtype=np.int32))
        n, width = v0.shape
        sweeps = int(sweeps)
        if segment is not None and int(segment) < 1:
            raise ValueError(f"segment must be >= 1, got {segment}")
        seg_size = max(1, sweeps) if segment is None else int(segment)
        if checkpoint is not None and record_trace:
            raise ValueError(
                "record_trace records host-replay state for the full "
                "run and cannot be checkpointed/resumed")
        if checkpoint is not None and collect_samples and archive is None:
            raise ValueError(
                "checkpointing with collect_samples requires an "
                "archive= to feed: bulk .samples live only in process "
                "memory and would be lost across a resume")
        tb, cfg, dev = self.tables, self.cfg, self.device
        mins, medians = norm.weights_arrays()
        mins_t, med_t = self._t(mins), self._t(medians)
        w_np = np.asarray(template.weights if weights is None else weights,
                          np.float64)
        if weights is not None and w_np.shape != (n, 6):
            raise ValueError(f"weights must be [{n}, 6], got {w_np.shape}")
        w = self._t(w_np)
        pair_t = None
        if pair_mask is not None:
            pair_ok = np.asarray(pair_mask, dtype=bool)
            if pair_ok.shape != (max(n - 1, 1),):
                raise ValueError(
                    f"pair_mask must be [{max(n - 1, 1)}], "
                    f"got {pair_ok.shape}")
            pair_t = self._t(pair_ok, dtype=torch.bool)
        temps_np = np.asarray(temps, np.float64)
        temps_t = self._t(temps_np)
        inv_t = 1.0 / temps_t
        region = self._region()
        key0 = trandom.PRNGKey(seed, dev)

        fp = carry_like = None
        if checkpoint is not None:
            price, embf, profile, pprofile = _db_region_cols(self.db)
            extra = {}
            if cfg.comm != "legacy":
                extra["comm"] = np.frombuffer(cfg.comm.encode(), np.uint8)
            if cfg.schedule != "fixed":
                extra["schedule"] = np.frombuffer(cfg.schedule.encode(),
                                                  np.uint8)
            if not np.all(pprofile == price):
                extra["pprofile"] = pprofile
            fp = segment_fingerprint(
                "device_pt", v0=v0, temps=temps_np, swap_every=swap_every,
                seed=seed, mins=mins, medians=medians,
                weights=(np.tile(w_np, (n, 1)) if weights is None
                         else w_np),
                pair_mask=(np.ones(max(n - 1, 1), dtype=bool)
                           if pair_mask is None else pair_ok),
                ci=np.float64(self.db.carbon_intensity), segment=segment,
                collect=collect_samples, price=price, embf=embf,
                profile=profile, **extra)
            carry_like = dict(
                v=np.zeros((n, width), np.int32),
                costs=np.zeros(n, np.float64),
                best_v=np.zeros(width, np.int32),
                best_c=np.zeros((), np.float64),
                key=trandom.key_to_np(key0))

        # host state the loop's hooks share: the history parts (device
        # tensors), the seed population's samples until a segment (or
        # flush_seed) feeds them, the seed costs for the trace
        st = dict(hist=None, seed_block=None, cost0=None)
        enc_parts: List[torch.Tensor] = []
        vec_parts: List[torch.Tensor] = []
        trace_parts: List[tuple] = []

        def feed(enc_s, vec_s):
            with trace.span("pf.archive.copy"):
                enc = trace.fetch(enc_s.reshape(-1, width).to(torch.int32),
                                  "archive").numpy()
                vec = trace.fetch(vec_s.reshape(-1, 3), "archive").numpy()
            archive.insert(enc, vec)

        def fresh():
            v = self._enc(v0)
            _, costs, vec0 = _eval_cost(v, mins_t, med_t, w, *region, tb,
                                        cfg)
            st["cost0"] = costs
            st["hist"] = [costs.min()[None]]
            if collect_samples:
                st["seed_block"] = (v.clone(), vec0)
            bi = _argmin_first(costs)
            with trace.synced("best", 2, 2 * bi.element_size()):
                return v, costs, v[bi].clone(), costs[bi].clone(), key0

        def from_restored(r):
            c = r.carry
            st["hist"] = [self._t(r.history)]
            return (self._enc(c["v"]), self._t(c["costs"]),
                    self._t(c["best_v"], I64), self._t(c["best_c"]),
                    trandom.key_from_np(c["key"], dev))

        def run_segment(carry, done, seg):
            v, costs, best_v, best_c, key = carry
            cold, props, vecs = [], [], []
            for sweep in range(done, done + seg):
                with trace.span("pf.sweep"):
                    key, kp, ka, ksw = trandom.split(key, 4)
                    prop = _propose(kp, v, tb, cfg)
                    _, pcost, pvec = _eval_cost(prop, mins_t, med_t, w,
                                                *region, tb, cfg)
                    with trace.span("pf.accept"):
                        u = trandom.uniform(ka, (n,))
                        delta = pcost - costs
                        accept = (delta <= 0) | (u < torch.exp(
                            -delta / torch.clamp(temps_t, min=1e-12)))
                        v = torch.where(accept[:, None], prop, v)
                        costs = torch.where(accept, pcost, costs)
                        acc = torch.where(accept, pcost, math.inf)
                        i = _argmin_first(acc)
                        # indexing by the device scalar i reads it back
                        with trace.synced("best", 3, 3 * i.element_size()):
                            better = acc[i] < best_c
                            best_c = torch.where(better, acc[i], best_c)
                            best_v = torch.where(better, prop[i], best_v)
                        us = trandom.uniform(ksw, (max(n - 1, 1),))
                    if sweep % swap_every == 0:
                        _exchange(v[None], costs[None], inv_t[None],
                                  us[None],
                                  None if pair_t is None else pair_t[None])
                    cold.append(costs[-1:].clone())
                    if collect_samples:
                        props.append(prop)
                        vecs.append(pvec)
                    if record_trace:
                        trace_parts.append((prop, pcost, u, us, accept,
                                            costs.clone(), best_c))
            return (v, costs, best_v, best_c, key), (cold, props, vecs)

        def absorb(ys, seg):
            cold, props, vecs = ys
            st["hist"].extend(cold)
            if not collect_samples:
                return
            enc_s, vec_s = torch.stack(props), torch.stack(vecs)
            if archive is None:
                enc_parts.append(enc_s)
                vec_parts.append(vec_s)
                return
            if st["seed_block"] is not None:
                enc_s = torch.cat([st["seed_block"][0][None], enc_s])
                vec_s = torch.cat([st["seed_block"][1][None], vec_s])
                st["seed_block"] = None
            feed(enc_s, vec_s)

        def carry_np(carry):
            v, costs, best_v, best_c, key = carry
            return dict(v=trace.fetch(v.to(torch.int32), "carry").numpy(),
                        costs=trace.fetch(costs, "carry").numpy(),
                        best_v=trace.fetch(best_v.to(torch.int32),
                                           "carry").numpy(),
                        best_c=trace.fetch(best_c, "carry").numpy(),
                        key=trandom.key_to_np(key))

        def flush_seed():
            # zero sweeps (or a restored run with none left): the seed
            # population is all there is to feed
            if st["seed_block"] is not None and archive is not None:
                feed(*st["seed_block"])
                st["seed_block"] = None

        carry, _ = run_segmented(
            sweeps=sweeps, seg_size=seg_size, checkpoint=checkpoint,
            resume=resume, fingerprint=fp, archives=archive,
            carry_like=carry_like, fresh=fresh,
            from_restored=from_restored, run_segment=run_segment,
            absorb=absorb, carry_np=carry_np,
            history_np=lambda: trace.fetch(torch.cat(st["hist"]),
                                           "carry").numpy(),
            sweep_counter=lambda done: done, flush_seed=flush_seed)
        v, costs, best_v, best_c, _ = carry
        seed_block = st["seed_block"]

        def host(t):
            return trace.fetch(t, "result").numpy()

        with trace.span("pf.result"):
            samples = None
            if collect_samples and archive is None:
                blocks_e = ([seed_block[0][None]] if seed_block is not None
                            else []) + enc_parts
                blocks_v = ([seed_block[1][None]] if seed_block is not None
                            else []) + vec_parts
                if blocks_e:
                    samples = dict(
                        enc=host(torch.cat(blocks_e).to(torch.int32)),
                        vec=host(torch.cat(blocks_v)))
            replay = None
            if record_trace:
                if trace_parts:
                    cols = [torch.stack(c) for c in zip(*trace_parts)]
                    cols[0] = cols[0].to(torch.int32)
                    cat = [host(c) for c in cols]
                else:
                    cat = [np.zeros((0,) + tail(n, width))
                           for tail in _TRACE_TAILS]
                replay = dict(zip(_TRACE_FIELDS, cat))
                replay["initial_costs"] = host(st["cost0"])
            return DevicePTResult(
                best_enc=host(best_v.to(torch.int32)),
                best_cost=float(trace.fetch(best_c, "result")),
                history=trace.fetch(torch.cat(st["hist"]),
                                    "result").tolist(),
                evaluations=n + n * sweeps,
                final_enc=host(v.to(torch.int32)),
                final_costs=host(costs), trace=replay,
                samples=samples)


# ---------------------------------------------------------------------------
# The stacked scenario engine: a region x workload grid as one population
# ---------------------------------------------------------------------------


def _tile_bucket(t: int) -> int:
    """Power-of-two tile-count bucket (>= 64) that the stacked tables pad
    every workload's tile axis to."""
    return max(64, 1 << (int(t) - 1).bit_length())


def _pad_tiles(a: np.ndarray, bucket: int, axis: int) -> np.ndarray:
    """Edge-pad a prefix table's T+1 axis to bucket+1 slots. Tile ranges
    never pass a workload's true total, and edge replication makes any
    clipped tail difference exactly zero anyway."""
    cur = a.shape[axis]
    if cur == bucket + 1:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, bucket + 1 - cur)
    return np.pad(a, pad, mode="edge")


def _stacked_tables(workloads, hosts, tb0: int, tb1: int,
                    dev: torch.device) -> dict:
    """The workload-stacked tables of the scenario engine on ``dev``.

    ``pref0_flatw``/``pref1_flatw`` are the int64 ``[5, Wk*A*S*3,
    bucket+1]`` stacks ``prefix_select`` reads at row ``((wi*A + a)*S +
    s)*3 + d`` (each workload's tables edge-padded to the shared bucket
    and concatenated along the rows; ``[5, 96, 65]`` for workloads 1+6),
    ``mn0w``/``mn1w`` the padded ``mn`` prefix rows ``[Wk, bucket+1]``,
    ``t0w``/``t1w`` each workload's true tile totals and ``wrw`` its
    DRAM write-back bits."""
    out = {}
    for sk, bucket in ((0, tb0), (1, tb1)):
        mats = []
        for h in hosts:
            pref = _pad_tiles(np.stack([h.tiles[sk]["pref"][f]
                                        for f in _SIM_METRICS]),
                              bucket, axis=-1)
            mats.append(pref.reshape(pref.shape[0], -1, bucket + 1))
        out[f"pref{sk}_flatw"] = torch.as_tensor(
            np.ascontiguousarray(np.concatenate(mats, axis=1)), device=dev)
        out[f"mn{sk}w"] = torch.as_tensor(np.stack(
            [_pad_tiles(h.tiles[sk]["mn_pref"], bucket, axis=0)
             for h in hosts]), device=dev)
        out[f"t{sk}w"] = torch.tensor([h.tiles[sk]["T"] for h in hosts],
                                      dtype=I64, device=dev)
    out["wrw"] = torch.tensor(
        [float(wl.M * wl.N * OPERAND_BYTES * 8) for wl in workloads],
        dtype=F64, device=dev)
    return out


@dataclasses.dataclass
class ScenarioPTResult:
    """Per-cell outputs of the stacked scenario tempering engine (host
    arrays; leading axis = scenario cell everywhere)."""

    best_enc: np.ndarray          # [S, width]
    best_cost: np.ndarray         # [S]
    history: np.ndarray           # [S, 1 + sweeps] coldest-chain costs
    evaluations: int              # total across all cells
    final_enc: np.ndarray         # [S, n, width]
    final_costs: np.ndarray       # [S, n]
    # every evaluated design + its OBJECTIVE_AXES vector, seed population
    # first: enc [1 + sweeps, S, n, width], vec [1 + sweeps, S, n, 3]
    samples: Optional[Dict[str, np.ndarray]] = None


class ScenarioEngine:
    """A whole (workload x deployment region) scenario grid as one
    population on one torch device.

    The S cells of a grid, ``n`` chains each, ride as one ``[S*n]``
    population (cell-major: row ``s*n + i`` is chain i of cell s)
    through the single-workload engine's stages. Every per-cell knob is
    a per-row tensor: the grid carbon intensity, price, embodied factor
    and 24h profiles, the normalizer and Eq. 17 weight rows, and the
    workload's tile totals and write-back bits (its prefix tables ride
    in the workload-stacked, tile-bucket-padded tables indexed by a
    per-cell workload id). So a sweep of the whole grid is one
    :func:`_propose`, one :func:`_eval_cost` — one ``prefix_select``
    launch — and one batched replica exchange, whatever S is.

    Per-cell RNG: the base key is folded with the cell index
    (``fold_in(key, s)``), and each cell splits its own stream every
    sweep, exactly as the reference's vmapped step does, so a cell's
    trajectory depends only on (seed, cell index).

    Tables are built once from the host :class:`~repro_torch.pathfinding.
    batch.BatchEvaluator` of each workload and live on ``torch_device``
    (``None`` = cuda)."""

    def __init__(self, workloads: Sequence[GEMMWorkload],
                 db: TechDB = DEFAULT_DB,
                 tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
                 space: Optional[DesignSpace] = None,
                 torch_device: DeviceLike = None):
        self.device = resolve_device(torch_device)
        self.workloads = tuple(workloads)
        if not self.workloads:
            raise ValueError("ScenarioEngine needs >= 1 workload")
        self.db, self.tile_sizes = db, tile_sizes
        hosts = [get_evaluator(wl, db, tile_sizes, space)
                 for wl in self.workloads]
        self.hosts = hosts
        self.space = hosts[0].space
        tb0 = _tile_bucket(max(h.tiles[0]["T"] for h in hosts))
        tb1 = _tile_bucket(max(h.tiles[1]["T"] for h in hosts))
        # cfg.T0/T1 are the bucket: they bound the padded mn gathers,
        # while each row's true totals come from the tables at run time
        self.cfg = _base_cfg(self.space, db, T0=tb0, T1=tb1, wr_bits=0.0)
        self.tables = {
            **_shared_tables(hosts[0], self.space, self.device),
            **_stacked_tables(self.workloads, hosts, tb0, tb1, self.device)}

    def _t(self, x, dtype=F64) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type:
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        with trace.synced("upload"):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _widx(self, widx, S: int) -> np.ndarray:
        # int32, as the reference holds it: the workload ids enter the
        # scenario fingerprint, which hashes their dtype
        w = np.asarray(widx, dtype=np.int32).reshape(S)
        if w.min(initial=0) < 0 or w.max(initial=0) >= len(self.workloads):
            raise ValueError(
                f"widx out of range for {len(self.workloads)} workloads")
        return w

    def _rows(self, n: int, widx, mins, med, w, ci, price, embf, profile,
              pprofile):
        """The per-cell constants of an S-cell grid as per-row tensors of
        its ``[S*n]`` population: the ``(mins, medians, w, ci, price,
        embf, profile, pprofile)`` arguments of :func:`_eval_cost` and
        its ``rt`` (workload id, true tile totals, write-back bits).
        ``w`` is one row a cell ``[S, 6]`` or one a chain ``[S, n, 6]``."""
        t, tb = self._t, self.tables
        wi = t(widx, I64).reshape(-1)
        S = wi.shape[0]
        w = t(w)
        w = (w.reshape(S * n, 6) if w.dim() == 3
             else w.reshape(S, 6).repeat_interleave(n, dim=0))
        mins, med, ci, price, embf, profile, pprofile = [
            t(x).reshape(S, -1).repeat_interleave(n, dim=0)
            for x in (mins, med, ci, price, embf, profile, pprofile)]
        wi = wi.repeat_interleave(n)
        rt = dict(wi=wi, T0=tb["t0w"][wi], T1=tb["t1w"][wi],
                  wr_bits=tb["wrw"][wi])
        return (mins, med, w, ci[:, 0], price[:, 0], embf[:, 0], profile,
                pprofile), rt

    @staticmethod
    def _region_cols(S: int, ci: np.ndarray, price=None, embf=None,
                     profile=None, pprofile=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """Normalize/synthesize the per-cell region columns: ``price``
        [S] (default zeros), ``embf`` [S] (default ones), ``profile``
        [S, 24] (default flat-at-ci rows, whose correction is exactly
        +0.0) and ``pprofile`` [S, 24] (default flat-at-price rows)."""
        ci = np.asarray(ci, np.float64).reshape(S)
        price = (np.zeros(S, np.float64) if price is None
                 else np.asarray(price, np.float64).reshape(S))
        embf = (np.ones(S, np.float64) if embf is None
                else np.asarray(embf, np.float64).reshape(S))
        profile = (np.repeat(ci[:, None], HOURS_PER_DAY, axis=1)
                   if profile is None
                   else np.asarray(profile, np.float64).reshape(
                       S, HOURS_PER_DAY))
        pprofile = (np.repeat(price[:, None], HOURS_PER_DAY, axis=1)
                    if pprofile is None
                    else np.asarray(pprofile, np.float64).reshape(
                        S, HOURS_PER_DAY))
        return price, embf, profile, pprofile

    def evaluate_cost(self, encoded: np.ndarray, mins: np.ndarray,
                      medians: np.ndarray, weights: np.ndarray,
                      ci: np.ndarray, widx: np.ndarray,
                      price: Optional[np.ndarray] = None,
                      embf: Optional[np.ndarray] = None,
                      profile: Optional[np.ndarray] = None,
                      pprofile: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused cost + objective vectors for a stacked ``[S, m, width]``
        population (per-cell ``[S, 6]`` normalizer and weight rows,
        ``[S]`` carbon intensities and workload ids, and the optional
        regional axes ``price`` [S], ``embf`` [S], ``profile`` [S, 24]
        and ``pprofile`` [S, 24], neutral when omitted), as one
        ``[S*m]`` evaluation: one ``prefix_select`` launch. Returns
        ``(cost [S, m], vec [S, m, 3])``."""
        v = np.asarray(encoded, dtype=np.int32)
        if v.ndim != 3:
            raise ValueError(f"encoded must be [S, m, width], got {v.shape}")
        S, m, width = v.shape
        ci_a = np.asarray(ci, np.float64).reshape(S)
        args, rt = self._rows(
            m, self._widx(widx, S), np.asarray(mins, np.float64),
            np.asarray(medians, np.float64), np.asarray(weights, np.float64),
            ci_a, *self._region_cols(S, ci_a, price, embf, profile,
                                     pprofile))
        _, cost, vec = _eval_cost(self._t(v.reshape(S * m, width), I64),
                                  *args, self.tables, self.cfg, rt)
        return (trace.fetch(cost.reshape(S, m), "result").numpy(),
                trace.fetch(vec.reshape(S, m, 3), "result").numpy())

    # -- the stacked tempering loop ------------------------------------

    def init_step(self, v0, mins, med, w, ci, price, embf, profile,
                  pprofile, widx, key, cell0: int = 0):
        """The seed evaluation of an S-cell grid (the reference's
        ``_init_fn(S, n)``): ``v0`` ``[S, n, W]`` seed populations, the
        per-cell ``mins`` / ``med`` ``[S, 6]``, ``w`` ``[S, n, 6]``,
        ``ci`` / ``price`` / ``embf`` ``[S]``, ``profile`` / ``pprofile``
        ``[S, 24]`` and ``widx`` ``[S]`` (tensors or arrays), and the
        base ``key`` (``[2]`` key words). Returns device tensors
        ``(keys0 [S, 2], cost0 [S, n], vec0 [S, n, 3])``: cell s's key
        stream ``fold_in(key, cell0 + s)`` and its seed costs and
        objective vectors, from one ``[S*n]`` evaluation (one
        ``prefix_select`` launch). ``cell0`` is the grid index of the
        first cell (a rank's block of a split grid), so a cell's stream
        depends only on the seed and its place in the grid."""
        t = self._t
        v = t(v0, I64)
        S, n, width = v.shape
        args, rt = self._rows(n, widx, mins, med, t(w).reshape(S, n, 6), ci,
                              price, embf, profile, pprofile)
        _, cost0, vec0 = _eval_cost(v.reshape(S * n, width), *args,
                                    self.tables, self.cfg, rt)
        keys0 = trandom.fold_in(t(key, I64),
                                torch.arange(S, device=self.device) + cell0)
        return keys0, cost0.reshape(S, n), vec0.reshape(S, n, 3)

    def segment_runner(self, S: int, n: int, seg: int, swap_every: int,
                       collect_samples: bool = False):
        """The segment step of :meth:`parallel_tempering`, for callers
        that drive segments themselves.

        The returned callable has the reference's positional signature
        ``run(v, costs, best_v, best_c, keys, sweep0, temps, mins, med,
        w, pair_ok, ci, price, embf, profile, pprofile, widx)``, plus a
        trailing ``noc_on`` [S] iff the engine is mesh_noc and a
        trailing ``sched_on`` [S] iff it is window-schedule. The carry
        ``(v [S, n, W], costs [S, n], best_v [S, W], best_c [S], keys
        [S, 2])`` and the per-cell constants (``temps`` [S, n], ``mins``
        / ``med`` [S, 6], ``w`` [S, n, 6], ``pair_ok`` [S, n-1], ``ci``
        / ``price`` / ``embf`` [S], ``profile`` / ``pprofile`` [S, 24],
        ``widx`` [S]) are tensors or arrays; ``sweep0`` is the host
        ``[S]`` integer array of per-cell sweep counters (cell s swaps
        at sweep t iff ``(sweep0[s] + t) % swap_every == 0``). It
        returns ``(carry, ys)``: the carry as device tensors, ``ys`` =
        ``(coldest costs [seg, S], best costs [seg, S])`` plus
        ``(proposals [seg, S, n, W], vectors [seg, S, n, 3])`` with
        ``collect_samples``."""
        S, n, seg, swap_every = int(S), int(n), int(seg), int(swap_every)
        collect = bool(collect_samples)
        n_gates = ((self.cfg.comm == "mesh_noc")
                   + (self.cfg.schedule == "window"))

        def run(v, costs, best_v, best_c, keys, sweep0, temps, mins, med,
                w, pair_ok, ci, price, embf, profile, pprofile, widx,
                *gates):
            if len(gates) != n_gates:
                raise TypeError(
                    f"this engine's segment takes {17 + n_gates} "
                    f"arguments, got {17 + len(gates)}")
            return self._segment(S, n, seg, swap_every, collect,
                                 (v, costs, best_v, best_c, keys), sweep0,
                                 temps, mins, med, w, pair_ok, ci, price,
                                 embf, profile, pprofile, widx, *gates)

        return run

    def _segment(self, S, n, seg, swap_every, collect, carry, sweep0,
                 temps, mins, med, w, pair_ok, ci, price, embf, profile,
                 pprofile, widx, *gates):
        tb, cfg, t = self.tables, self.cfg, self._t
        P = S * n
        v, costs, best_v, best_c, keys = (
            t(carry[0], I64), t(carry[1]), t(carry[2], I64), t(carry[3]),
            t(carry[4], I64))
        width = v.shape[-1]
        temps = t(temps).reshape(S, n)
        inv_t = 1.0 / temps
        args, rt = self._rows(n, widx, mins, med, t(w).reshape(S, n, 6), ci,
                              price, embf, profile, pprofile)
        gate_rows = [t(g).reshape(S).repeat_interleave(n) for g in gates]
        noc_r = gate_rows.pop(0) if cfg.comm == "mesh_noc" else None
        sched_r = gate_rows.pop(0) if cfg.schedule == "window" else None
        pair = t(pair_ok, torch.bool).reshape(S, max(n - 1, 1))
        # the swap schedule is host data: per sweep, no cell swaps (the
        # exchange is skipped), every cell swaps (pair_ok alone gates),
        # or some do (an [S] mask joins the gate)
        do = ((np.asarray(sweep0, np.int64).reshape(1, S)
               + np.arange(seg)[:, None]) % swap_every) == 0
        mixed = do.any(axis=1) & ~do.all(axis=1)
        do_t = t(do, torch.bool) if mixed.any() else None
        rows = torch.arange(S, device=self.device)
        cold, best, props, vecs = [], [], [], []
        for k in range(seg):
            with trace.span("pf.sweep"):
                ks = trandom.split(keys, 4)
                keys, kp, ka, ksw = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
                prop = _propose(kp, v.reshape(P, width), tb, cfg, noc_r,
                                sched_r)
                _, pcost, pvec = _eval_cost(prop, *args, tb, cfg, rt)
                with trace.span("pf.accept"):
                    prop = prop.reshape(S, n, width)
                    pcost = pcost.reshape(S, n)
                    u = trandom.uniform(ka, (n,))
                    delta = pcost - costs
                    accept = (delta <= 0) | (
                        u < torch.exp(-delta / torch.clamp(temps, min=1e-12)))
                    v = torch.where(accept[..., None], prop, v)
                    costs = torch.where(accept, pcost, costs)
                    acc = torch.where(accept, pcost, math.inf)
                    i = _argmin_first(acc)
                    cand_c, cand_v = acc[rows, i], prop[rows, i]
                    us = trandom.uniform(ksw, (max(n - 1, 1),))
                if do[k].any():
                    _exchange(v, costs, inv_t, us,
                              pair & do_t[k][:, None] if mixed[k] else pair)
                with trace.span("pf.accept"):
                    better = cand_c < best_c
                    best_c = torch.where(better, cand_c, best_c)
                    best_v = torch.where(better[:, None], cand_v, best_v)
                cold.append(costs[:, -1])
                best.append(best_c)
                if collect:
                    props.append(prop)
                    vecs.append(pvec.reshape(S, n, 3))
        ys = (torch.stack(cold), torch.stack(best))
        if collect:
            ys = ys + (torch.stack(props), torch.stack(vecs))
        return (v, costs, best_v, best_c, keys), ys

    @trace.spanned("pf.engine")
    def parallel_tempering(self, v0: np.ndarray, temps, sweeps: int,
                           swap_every: int, seed: int, mins, medians,
                           weights, pair_mask, ci, widx,
                           price=None, embf=None, profile=None,
                           pprofile=None, noc_on=None, sched_on=None,
                           collect_samples: bool = True,
                           mesh=None, segment: Optional[int] = None,
                           checkpoint=None, resume: bool = True,
                           archives: Optional[Sequence] = None
                           ) -> ScenarioPTResult:
        """Run the whole scenario grid's tempering loop.

        ``v0`` is ``[S, n, width]`` (cell-major seed populations),
        ``temps`` / ``weights`` / ``pair_mask`` the per-cell ladders
        ``[S, n]``, Eq. 17 rows ``[S, n, 6]`` and exchange gates ``[S,
        n-1]``, ``mins`` / ``medians`` the per-cell normalizer rows,
        ``ci`` the per-cell grid carbon intensities and ``widx`` the
        per-cell workload indices into this engine's workloads.
        ``price`` / ``embf`` / ``profile`` / ``pprofile`` are the
        optional per-cell regional axes ([S], [S], [S, 24], [S, 24]);
        omitted axes take their neutral columns. ``noc_on`` ([S],
        mesh_noc engines only) and ``sched_on`` ([S], window engines
        only) gate each cell's NoC and schedule move levels (default:
        the space's liveness).

        ``segment`` / ``checkpoint`` / ``resume`` / ``archives`` mirror
        :meth:`DeviceEvaluator.parallel_tempering`: the loop advances in
        host-driven chunks (default: one chunk) without changing a bit,
        the carry (with the per-cell sweep counters and key words) and
        the per-cell archives snapshot at every boundary, and ``resume``
        restores the newest snapshot of this grid. ``archives`` (one
        :class:`~repro_torch.pathfinding.pareto.ParetoArchive` per cell)
        are fed every evaluated design at each segment end in place of
        returning ``.samples``. ``mesh`` (from
        :func:`~repro_torch.distributed.scenario_mesh`) splits the
        cells over its ranks (:func:`~repro_torch.distributed.
        shard_scenarios`): each rank runs its block of cells, every
        cell's key folds in its grid index, and the per-cell carry,
        history and samples are all-gathered, so every rank feeds its
        archives and returns what one rank returns, bit for bit. Only
        rank 0 writes checkpoints; a restored carry is re-placed (each
        rank keeps its block). When the ranks do not divide the cells,
        or on a one-device mesh, every rank runs the whole grid."""
        from repro_torch.pathfinding.resume import (
            RankZeroCheckpoint,
            run_segmented,
            segment_fingerprint,
        )

        v0 = np.asarray(v0, dtype=np.int32)
        if v0.ndim != 3:
            raise ValueError(f"v0 must be [S, n, width], got {v0.shape}")
        S, n, width = v0.shape
        sweeps = int(sweeps)
        if segment is not None and int(segment) < 1:
            raise ValueError(f"segment must be >= 1, got {segment}")
        seg_size = max(1, sweeps) if segment is None else int(segment)
        if checkpoint is not None and collect_samples \
                and archives is None:
            raise ValueError(
                "checkpointing with collect_samples requires "
                "archives= to feed: bulk .samples live only in "
                "process memory and would be lost across a resume")
        if archives is not None and len(archives) != S:
            raise ValueError(
                f"need one archive per cell: {len(archives)} != {S}")
        widx_a = self._widx(widx, S)
        gates = []
        for name, on, live, kind in (
                ("noc_on", noc_on, self.space.noc_live, "mesh_noc"),
                ("sched_on", sched_on, self.space.sched_live, "window")):
            if kind in (self.cfg.comm, self.cfg.schedule):
                gates.append(np.full(S, 1.0 if live else 0.0) if on is None
                             else np.asarray(on, np.float64).reshape(S))
            elif on is not None:
                raise ValueError(
                    "noc_on is only meaningful for mesh_noc engines"
                    if name == "noc_on" else
                    "sched_on is only meaningful for window-schedule "
                    "engines")
        t, dev = self._t, self.device
        if mesh is not None and shd.mesh_device_of(mesh).type != dev.type:
            raise ValueError(f"mesh {mesh} is not on this engine's "
                             f"device ({dev})")
        lo, hi = (0, S) if mesh is None else shd.scenario_block(S, mesh)
        split = (lo, hi) != (0, S)

        def whole(x, dim=0):
            """The grid's rows of this rank's block ``x``."""
            return shd.gather_scenarios(x, mesh, S, dim) if split else x
        ci_a = np.asarray(ci, np.float64).reshape(S)
        price_a, embf_a, profile_a, pprofile_a = self._region_cols(
            S, ci_a, price, embf, profile, pprofile)
        arrays = dict(
            temps=np.asarray(temps, np.float64).reshape(S, n),
            mins=np.asarray(mins, np.float64).reshape(S, 6),
            med=np.asarray(medians, np.float64).reshape(S, 6),
            w=np.asarray(weights, np.float64).reshape(S, n, 6),
            pair_ok=np.asarray(pair_mask, bool).reshape(S, max(n - 1, 1)))
        placed = dict(
            temps=t(arrays["temps"]), mins=t(arrays["mins"]),
            med=t(arrays["med"]), w=t(arrays["w"]),
            pair_ok=t(arrays["pair_ok"], torch.bool), ci=t(ci_a),
            price=t(price_a), embf=t(embf_a), profile=t(profile_a),
            pprofile=t(pprofile_a), widx=t(widx_a, I64),
            **{f"gate{i}": t(g) for i, g in enumerate(gates)})
        if mesh is not None:
            from repro_torch.distributed import shard_scenarios

            placed = shard_scenarios(placed, mesh)
            if split and checkpoint is not None:
                checkpoint = RankZeroCheckpoint(checkpoint, mesh)
        consts = tuple(placed.values())
        key0 = trandom.PRNGKey(seed, dev)

        fp = carry_like = None
        if checkpoint is not None:
            extra = {}
            if self.cfg.comm != "legacy":
                extra["comm"] = np.frombuffer(self.cfg.comm.encode(),
                                              np.uint8)
                extra["noc_on"] = gates[0]
            if self.cfg.schedule != "fixed":
                extra["schedule"] = np.frombuffer(
                    self.cfg.schedule.encode(), np.uint8)
                extra["sched_on"] = gates[-1]
            if not np.all(pprofile_a == price_a[:, None]):
                extra["pprofile"] = pprofile_a
            fp = segment_fingerprint(
                "scenario_pt", v0=v0, temps=arrays["temps"],
                swap_every=swap_every, seed=seed, mins=arrays["mins"],
                medians=arrays["med"], weights=arrays["w"],
                pair_mask=arrays["pair_ok"], ci=ci_a, segment=segment,
                collect=collect_samples, widx=widx_a, price=price_a,
                embf=embf_a, profile=profile_a, **extra)
            carry_like = dict(
                v=np.zeros((S, n, width), np.int32),
                costs=np.zeros((S, n), np.float64),
                best_v=np.zeros((S, width), np.int32),
                best_c=np.zeros(S, np.float64),
                keys=np.zeros((S, 2), np.uint32))

        # host state the loop's hooks share: history parts [S, k], the
        # seed block until a segment (or flush_seed) feeds it, and the
        # per-cell sweep counters
        st = dict(hist=None, seed_block=None,
                  sweep_done=np.zeros(S, dtype=np.int64))
        enc_parts: List[np.ndarray] = []
        vec_parts: List[np.ndarray] = []

        def feed(enc_s, vec_s):
            for s in range(S):
                archives[s].insert(enc_s[:, s].reshape(-1, width),
                                   vec_s[:, s].reshape(-1, 3))

        def fresh():
            keys0, cost0, vec0 = self.init_step(v0[lo:hi], *consts[1:4],
                                                *consts[5:11], key0,
                                                cell0=lo)
            v = t(v0[lo:hi], I64)
            bi = _argmin_first(cost0)
            rows = torch.arange(hi - lo, device=dev)
            st["hist"] = [trace.fetch(whole(cost0.amin(dim=1)),
                                      "history").numpy()[:, None]]
            if collect_samples:
                with trace.span("pf.archive.copy"):
                    st["seed_block"] = (v0[None], trace.fetch(
                        whole(vec0)[None], "archive").numpy())
            return v, cost0, v[rows, bi], cost0[rows, bi], keys0

        def from_restored(r):
            c = {k: np.asarray(x)[lo:hi] for k, x in r.carry.items()}
            st["sweep_done"] = np.asarray(r.sweep_done_per_cell,
                                          dtype=np.int64).reshape(S)
            st["hist"] = [np.asarray(r.history, np.float64).reshape(S, -1)]
            return (t(c["v"], I64), t(c["costs"]), t(c["best_v"], I64),
                    t(c["best_c"]), trandom.key_from_np(c["keys"], dev))

        def run_segment(carry, done, seg):
            run = self.segment_runner(hi - lo, n, seg, swap_every,
                                      collect_samples)
            return run(*carry, st["sweep_done"][lo:hi], *consts)

        def absorb(ys, seg):
            st["hist"].append(trace.fetch(whole(ys[0], 1).T,
                                          "history").numpy())
            if collect_samples:
                with trace.span("pf.archive.copy"):
                    enc_s = trace.fetch(whole(ys[2], 1).to(torch.int32),
                                        "archive").numpy()
                    vec_s = trace.fetch(whole(ys[3], 1), "archive").numpy()
                if st["seed_block"] is not None:
                    enc_s = np.concatenate([st["seed_block"][0], enc_s])
                    vec_s = np.concatenate([st["seed_block"][1], vec_s])
                    st["seed_block"] = None
                if archives is not None:
                    feed(enc_s, vec_s)
                else:
                    enc_parts.append(enc_s)
                    vec_parts.append(vec_s)
            st["sweep_done"] = st["sweep_done"] + seg

        def carry_np(carry):
            v, costs, best_v, best_c, keys = (whole(x) for x in carry)
            return dict(v=trace.fetch(v.to(torch.int32), "carry").numpy(),
                        costs=trace.fetch(costs, "carry").numpy(),
                        best_v=trace.fetch(best_v.to(torch.int32),
                                           "carry").numpy(),
                        best_c=trace.fetch(best_c, "carry").numpy(),
                        keys=trandom.key_to_np(keys))

        def flush_seed():
            # zero sweeps (or a restored run with none left): the seed
            # population is all there is to feed
            if st["seed_block"] is not None and archives is not None:
                feed(*st["seed_block"])
                st["seed_block"] = None

        carry, _ = run_segmented(
            sweeps=sweeps, seg_size=seg_size, checkpoint=checkpoint,
            resume=resume, fingerprint=fp, archives=archives,
            carry_like=carry_like, fresh=fresh,
            from_restored=from_restored, run_segment=run_segment,
            absorb=absorb, carry_np=carry_np,
            history_np=lambda: np.concatenate(st["hist"], axis=1),
            sweep_counter=lambda done: st["sweep_done"],
            flush_seed=flush_seed)
        seed_block = st["seed_block"]

        samples = None
        if collect_samples and archives is None:
            blocks_e = ([seed_block[0]] if seed_block is not None
                        else []) + enc_parts
            blocks_v = ([seed_block[1]] if seed_block is not None
                        else []) + vec_parts
            if blocks_e:
                samples = dict(enc=np.concatenate(blocks_e),
                               vec=np.concatenate(blocks_v))
        with trace.span("pf.result"):
            v_fin, costs_fin, best_v, best_c = (whole(x) for x in carry[:4])
            return ScenarioPTResult(
                best_enc=trace.fetch(best_v.to(torch.int32),
                                     "result").numpy(),
                best_cost=trace.fetch(best_c, "result").numpy(),
                history=np.concatenate(st["hist"], axis=1),
                evaluations=S * n * (1 + sweeps),
                final_enc=trace.fetch(v_fin.to(torch.int32),
                                      "result").numpy(),
                final_costs=trace.fetch(costs_fin, "result").numpy(),
                samples=samples)


# ---------------------------------------------------------------------------
# Cached evaluators + functional entry points
# ---------------------------------------------------------------------------

_DEVICE_EVALUATORS: Dict[tuple, Tuple[TechDB, DeviceEvaluator]] = {}
_DEVICE_EVALUATOR_CACHE_MAX = 8


def get_device_evaluator(wl: GEMMWorkload, db: TechDB = DEFAULT_DB,
                         tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
                         space: Optional[DesignSpace] = None,
                         torch_device: DeviceLike = None
                         ) -> DeviceEvaluator:
    """Cached :class:`DeviceEvaluator`, one per (workload, db, tiles,
    space layout, torch device) like ``get_evaluator``."""
    from repro_torch.pathfinding.batch import (
        cached_evaluator,
        evaluator_cache_key,
    )

    dev = resolve_device(torch_device)
    key = evaluator_cache_key(wl, db, tile_sizes, space) + (str(dev),)
    return cached_evaluator(
        _DEVICE_EVALUATORS, key, db,
        lambda: DeviceEvaluator(wl, db, tile_sizes, space, dev),
        _DEVICE_EVALUATOR_CACHE_MAX)


def evaluate_batch_device(encoded: np.ndarray, wl: GEMMWorkload,
                          db: TechDB = DEFAULT_DB,
                          tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
                          space: Optional[DesignSpace] = None,
                          torch_device: DeviceLike = None) -> MetricsBatch:
    """The device counterpart of
    :func:`repro_torch.pathfinding.evaluate_batch`: the metrics of the
    encoded rows from the cached :class:`DeviceEvaluator` on
    ``torch_device``."""
    return get_device_evaluator(wl, db, tile_sizes, space,
                                torch_device=torch_device).metrics(encoded)


_SCENARIO_ENGINES: Dict[tuple, Tuple[TechDB, ScenarioEngine]] = {}
_SCENARIO_ENGINE_CACHE_MAX = 4


def get_scenario_engine(workloads: Sequence[GEMMWorkload],
                        db: TechDB = DEFAULT_DB,
                        tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
                        space: Optional[DesignSpace] = None,
                        torch_device: DeviceLike = None) -> ScenarioEngine:
    """Cached :class:`ScenarioEngine` per (workload tuple, db, tiles,
    space layout, torch device), the stacked twin of
    :func:`get_device_evaluator`. The db's load profile and router share
    enter the key as values, so two TechDBs that differ only there never
    share an engine even if an ``id()`` is recycled."""
    from repro_torch.pathfinding.batch import (
        cached_evaluator,
        evaluator_cache_key,
    )

    dev = resolve_device(torch_device)
    workloads = tuple(workloads)
    key = evaluator_cache_key(workloads, db, tile_sizes, space) + (
        tuple(db.load_profile), db.router_area_frac, str(dev))
    return cached_evaluator(
        _SCENARIO_ENGINES, key, db,
        lambda: ScenarioEngine(workloads, db, tile_sizes, space, dev),
        _SCENARIO_ENGINE_CACHE_MAX)


def propose_batch(encoded: np.ndarray, wl: GEMMWorkload,
                  db: TechDB = DEFAULT_DB,
                  space: Optional[DesignSpace] = None,
                  seed: int = 0,
                  torch_device: DeviceLike = None) -> np.ndarray:
    """Vectorized hierarchical moves over encoded rows (see
    :func:`_propose`); invalid candidates keep the incumbent row."""
    return get_device_evaluator(wl, db, space=space,
                                torch_device=torch_device
                                ).propose(encoded, seed)
