"""The plain torch version of the topology kernel: the fused
evaluator's topology stage, written as tensor operations on ``[P, C]``
rows (one small op per slot, pair, level and step).

:func:`topology_plain` takes an encoded population ``v`` (int64 ``[P,
W]``), its per-slot die areas ``areas`` (float64 ``[P, C]``), the
evaluator's tables ``tb`` (``m_bw``, ``p25``, ``p25_interp``, ``p3``) and
its static constants ``cfg`` (``C``, ``L``, ``M``, ``n_pairs25``,
``n_pairs3``, ``acost``, ``hop_uniform``), and returns the topology dict
that :func:`repro_torch.pathfinding.device._metrics` reads: the 3D chain
and planar order, the slicing floorplan, the plane-pair and chain-bond
links with the Eq. 6 perimeter cap, the link-id table, the DRAM attach
(``eff_bw``, ``dram_e``), the per-source BFS with queue-order ties, the
reduction routes (``hops``, ``hops3``, ``inc``) and the package terms.

Its operation order is the contract that the CUDA kernel keeps bit for
bit: the floorplan's greedy accumulation order, the sequential planar
sum, stable argsorts and first-index argmax. Scatters onto permutations
are written as one-hot sums, which are exact and deterministic on CUDA.
:func:`bonding` is the tail both versions run in torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.pathfinding.space import (
    COL_MEM,
    COL_N,
    COL_PAIR25,
    COL_PAIR3,
    COL_STACK,
    COL_STYLE,
    S_25D,
    S_2D,
    S_3D,
    S_HYBRID,
)
from repro_torch.runtime import trace

F64 = torch.float64
I64 = torch.int64


def _first_index(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), the
    tie rule of ``jnp.argmax``."""
    n = hit.shape[-1]
    pos = torch.arange(n, device=hit.device)
    idx = torch.where(hit, pos, n).amin(dim=-1)
    return torch.where(idx == n, 0, idx)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    return _first_index(x == x.amax(dim=-1, keepdim=True))


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=1, stable=True)


def _scatter_perm(idx: torch.Tensor, val: torch.Tensor, C: int
                  ) -> torch.Tensor:
    """``zeros[P, C].at[rows, idx].add(val)`` for targets where at most
    one value per slot is nonzero: a one-hot sum, exact in any order."""
    slot = torch.arange(C, device=idx.device)
    hit = idx[:, :, None] == slot[None, None, :]
    return torch.where(hit, val[:, :, None], 0.0).sum(dim=1)


def bonding(is2d, is25, is3d, ishyb, n_f, m_f, cl_f, y25, y3, cfp3,
            a_bond):
    """The bonding yield (Eq. 15) and the 3D bonding carbon of each row,
    from its style flags, its die, planar and chain counts (float64), its
    package yields and 3D carbon rate, and ``a_bond`` ``[P, C]``: the
    chain's die areas at tiers 1 .. chain length - 1, 0.0 elsewhere.
    Both versions of the stage run it in torch: its ``**`` and its row
    sum keep torch's own rounding and reduction order."""
    bond_y = torch.where(
        is2d, 1.0,
        torch.where(is25, y25 ** n_f,
                    torch.where(is3d, y3 ** (n_f - 1.0),
                                (y25 ** m_f) * (y3 ** (cl_f - 1.0)))))
    p3_bonded = torch.where(is3d | ishyb, cfp3 * a_bond.sum(dim=1), 0.0)
    return bond_y, p3_bonded


def topology_plain(v, areas, tb, cfg):
    """The topology dict of an encoded population; see the module
    docstring."""
    C, L = cfg.C, cfg.L
    P = v.shape[0]
    dev = v.device
    rows = torch.arange(P, device=dev)
    slot = torch.arange(C, device=dev)

    n = v[:, COL_N]
    style = v[:, COL_STYLE]
    is2d = style == S_2D
    is25 = style == S_25D
    is3d = style == S_3D
    ishyb = style == S_HYBRID
    active = slot[None, :] < n[:, None]

    memtot = tb["m_bw"][torch.clamp(v[:, COL_MEM], 0, cfg.M - 1)]
    p25i = torch.clamp(v[:, COL_PAIR25], 0, cfg.n_pairs25 - 1)
    p3i = torch.clamp(v[:, COL_PAIR3], 0, cfg.n_pairs3 - 1)
    p25row = tb["p25"][p25i]  # one gather for all 7 package fields
    pitch25, y25, cfp25, scale25, rate25, eta25, ebit25 = [
        p25row[:, i] for i in range(7)]
    interp25 = tb["p25_interp"][p25i]
    p3row = tb["p3"][p3i]
    pitch3, y3, cfp3, scale3, rate3, eta3, ebit3 = [
        p3row[:, i] for i in range(7)]

    # -- 3D chain: members sorted by non-increasing area, ties by index ----
    member = ((v[:, COL_STACK][:, None] >> slot[None, :]) & 1) == 1
    member = torch.where(ishyb[:, None], member & active,
                         is3d[:, None] & active)
    chain_len = member.sum(dim=1)
    chain_slots = _argsort(torch.where(member, -areas, math.inf))
    a_chain = torch.gather(areas, 1, chain_slots)
    base_slot = chain_slots[:, 0]
    tier = torch.arange(C, device=dev)
    tmask = (tier[None, :] >= 1) & (tier[None, :] < chain_len[:, None])
    # Eq. 7 per bond: bumps over the (smaller) upper die's face
    face = torch.minimum(a_chain[:, :-1], a_chain[:, 1:])
    nb3 = torch.clamp(torch.trunc(face * 1e6 / (pitch3 * pitch3)[:, None]),
                      min=1.0)
    cbw = rate3[:, None] * 1e9 * nb3 * eta3[:, None]
    bond_exists = ((torch.arange(C - 1, device=dev)[None, :] + 1
                    < chain_len[:, None]) & (is3d | ishyb)[:, None])

    # -- planar set in floorplan input order: non-members asc + base -------
    planar_mask = active & ~member
    porder = _argsort(torch.where(planar_mask, slot[None, :], C + 1))
    n_nonmem = planar_mask.sum(dim=1)
    porder = torch.where(ishyb[:, None] & (slot[None, :] == n_nonmem[:, None]),
                         base_slot[:, None], porder)
    m_planar = n_nonmem + ishyb.to(I64)
    pvalid = slot[None, :] < m_planar[:, None]
    ar_p = torch.where(pvalid, torch.gather(areas, 1, porder), 0.0)

    # planar-order sequential sums (parity with Python sum())
    tot = torch.zeros(P, dtype=F64, device=dev)
    for j in range(C):
        tot = tot + ar_p[:, j]
    side = torch.sqrt(tot * (1.0 + 0.10))

    # -- slicing floorplan, recursion unrolled level by level --------------
    # the greedy iteration order (area desc, ties by input position) is
    # invariant across levels: children receive items already sorted;
    # per-group accumulation is pairwise same-group comparison in the
    # exact scalar iteration order
    sorder = _argsort(torch.where(pvalid, -ar_p, math.inf))
    inv_sorder = _argsort(sorder)
    a_s = torch.gather(ar_p, 1, sorder)       # sorted areas
    v_s = torch.gather(pvalid, 1, sorder)
    contrib = [torch.where(v_s[:, t], a_s[:, t], 0.0) for t in range(C)]
    g = torch.zeros((P, C), dtype=I64, device=dev)
    bx = torch.zeros((P, C), dtype=F64, device=dev)
    by = torch.zeros((P, C), dtype=F64, device=dev)
    bwid = side[:, None].expand(P, C)
    bhei = side[:, None].expand(P, C)
    zero = torch.zeros(P, dtype=F64, device=dev)
    for level in range(max(C - 1, 1)):
        g_s = torch.gather(g, 1, sorder)
        # greedy pass in sorted order: left iff al <= ar of the item's
        # group so far (prefix sums in the exact scalar iteration order)
        left_s = []
        for t in range(C):
            al_t = zero
            ar_t = zero
            for t2 in range(t):
                same = g_s[:, t2] == g_s[:, t]
                al_t = al_t + torch.where(same & left_s[t2], contrib[t2], 0.0)
                ar_t = ar_t + torch.where(same & ~left_s[t2], contrib[t2],
                                          0.0)
            left_s.append(al_t <= ar_t)
        # final per-group totals / counts, accumulated per original
        # position in the same sorted order as the scalar greedy
        # (skipped other-group items add 0.0, which is exact)
        frac_cols, split_cols = [], []
        for j in range(C):
            gj = g[:, j]
            al_j = zero
            ar_j = zero
            cnt_j = torch.zeros(P, dtype=I64, device=dev)
            for t2 in range(C):
                same = g_s[:, t2] == gj
                al_j = al_j + torch.where(same & left_s[t2], contrib[t2], 0.0)
                ar_j = ar_j + torch.where(same & ~left_s[t2], contrib[t2],
                                          0.0)
                cnt_j = cnt_j + (same & v_s[:, t2]).to(I64)
            den = al_j + ar_j
            frac_cols.append(al_j / torch.where(den > 0, den, 1.0))
            split_cols.append(cnt_j >= 2)
        frac_j = torch.stack(frac_cols, dim=1)
        split_j = torch.stack(split_cols, dim=1) & pvalid
        goleft = torch.gather(torch.stack(left_s, dim=1), 1, inv_sorder)
        if level % 2 == 0:  # vertical cut, alternating by depth
            wl_ = bwid * frac_j
            bx = torch.where(split_j & ~goleft, bx + wl_, bx)
            bwid = torch.where(split_j,
                               torch.where(goleft, wl_, bwid - wl_), bwid)
        else:
            hl_ = bhei * frac_j
            by = torch.where(split_j & ~goleft, by + hl_, by)
            bhei = torch.where(split_j,
                               torch.where(goleft, hl_, bhei - hl_), bhei)
        g = torch.where(split_j, g * 2 + (~goleft).to(I64), g * 2)
    width = torch.where(pvalid, bx + bwid, -math.inf).amax(dim=1)
    height = torch.where(pvalid, by + bhei, -math.inf).amax(dim=1)
    bbox = width * height

    # -- links in a fixed slot layout: plane pairs then chain bonds --------
    pairs = [(j1, j2) for j1 in range(C) for j2 in range(j1 + 1, C)]
    plane_row = is25 | ishyb
    tol = 1e-9
    with trace.synced("pairs", 2):      # two uploads of host lists
        j1v = torch.tensor([j1 for j1, _ in pairs], dtype=I64, device=dev)
        j2v = torch.tensor([j2 for _, j2 in pairs], dtype=I64, device=dev)
    x1, y1, w1, h1 = bx[:, j1v], by[:, j1v], bwid[:, j1v], bhei[:, j1v]
    x2, y2, w2, h2 = bx[:, j2v], by[:, j2v], bwid[:, j2v], bhei[:, j2v]
    cond_v = (torch.abs(x1 + w1 - x2) < tol) | (torch.abs(x2 + w2 - x1) < tol)
    lo_v = torch.where(y1 > y2, y1, y2)
    hi_v = torch.minimum(y1 + h1, y2 + h2)
    edge_v = torch.where(hi_v > lo_v, hi_v - lo_v, 0.0)
    cond_h = (torch.abs(y1 + h1 - y2) < tol) | (torch.abs(y2 + h2 - y1) < tol)
    lo_h = torch.where(x1 > x2, x1, x2)
    hi_h = torch.minimum(x1 + w1, x2 + w2)
    edge_h = torch.where(hi_h > lo_h, hi_h - lo_h, 0.0)
    edge = torch.where(cond_v, edge_v, torch.where(cond_h, edge_h, 0.0))
    r25 = (rate25 * 1e9)[:, None]
    e25 = eta25[:, None]
    pit25 = pitch25[:, None]
    bwk = r25 * torch.clamp(torch.trunc(edge * 1e3 / pit25), min=1.0) * e25
    for aa in (ar_p[:, j1v], ar_p[:, j2v]):  # Eq. 6 endpoint perimeter cap
        perim = 4.0 * torch.sqrt(aa)
        bwk = torch.minimum(
            bwk, r25 * torch.clamp(torch.trunc(perim * 1e3 / pit25), min=1.0)
            * e25)
    s1a = torch.cat([porder[:, j1v], chain_slots[:, :C - 1]], dim=1)
    s2a = torch.cat([porder[:, j2v], chain_slots[:, 1:]], dim=1)
    exa = torch.cat(
        [plane_row[:, None] & (j2v[None, :] < m_planar[:, None])
         & (edge > 1e-9), bond_exists], dim=1)
    link_bw = torch.where(exa, torch.cat([bwk, cbw], dim=1), math.inf)
    link_e = torch.where(
        exa, torch.cat([ebit25[:, None].expand_as(bwk),
                        ebit3[:, None].expand_as(cbw)], dim=1), 0.0)
    # one-hot reduction instead of scatters: valid links never collide
    # (plane links have at most one stacked endpoint — the base — while
    # chain bonds have two), so the sum packs exact link ids
    pm_half = ((s1a[:, :, None] == slot[None, None, :])[:, :, :, None]
               & (s2a[:, :, None] == slot[None, None, :])[:, :, None, :]
               & exa[:, :, None, None])                 # [P, L, C, C]
    kplus1 = torch.arange(1, L + 1, dtype=I64, device=dev)[None, :, None,
                                                          None]
    lid_half = torch.sum(pm_half * kplus1, dim=1)
    lid = lid_half + lid_half.transpose(1, 2) - 1
    adj = lid >= 0

    # -- DRAM attach: planar shares, base-die-mediated chain (Eqs. 8-10) ---
    share = memtot[:, None] * ar_p / torch.where(tot > 0, tot, 1.0)[:, None]
    # only hybrid rows read it, where n_nonmem < n <= C; other rows may
    # point one past the last slot and are clamped
    base_share = torch.gather(
        share, 1, torch.clamp(n_nonmem, max=C - 1)[:, None])[:, 0]
    base_bw0 = torch.where(ishyb, base_share, memtot)
    cmin = torch.cummin(torch.where(bond_exists, cbw, math.inf), dim=1).values
    eff_chain = torch.minimum(base_bw0[:, None], cmin)
    plane_val = torch.where(pvalid & plane_row[:, None], share, 0.0)
    chain_val = torch.cat(
        [torch.where((chain_len > 0) & is3d, memtot, 0.0)[:, None],
         torch.where(tmask[:, 1:] & (is3d | ishyb)[:, None],
                     eff_chain, 0.0)], dim=1)
    # porder may name the base die twice in hybrid rows, once with a
    # 0.0 value: the one-hot sums stay exact
    eff_bw = _scatter_perm(porder, plane_val, C) + _scatter_perm(
        chain_slots, chain_val, C)
    dram_val = torch.where(tmask & (is3d | ishyb)[:, None],
                           tier[None, :] * ebit3[:, None], 0.0)
    dram_e = _scatter_perm(chain_slots, dram_val, C)
    eff_bw[:, 0] = torch.where(is2d, memtot, eff_bw[:, 0])

    # -- reduction routes: BFS per source, queue-order tie-breaking --------
    dest = _argmax_first(torch.where(active, areas, -1.0))
    INF_I = 10 ** 6
    eye = torch.eye(C, dtype=torch.bool, device=dev)[None]
    ordv = torch.where(eye, 0, INF_I).to(I64).expand(P, C, C)
    prev = torch.where(eye, slot[None, :, None], -1).to(I64).expand(P, C, C)
    counter = torch.ones((P, C), dtype=I64, device=dev)
    # step k processes the (unique) node with discovery rank k — exactly
    # the scalar queue pop order. C-1 steps suffice: a node with rank k
    # is found while processing rank k-1 <= C-2
    for k in range(max(C - 1, 1)):
        at_k = ordv == k
        u = _first_index(at_k)
        valid_u = at_k.any(dim=2)
        adj_u = adj[rows[:, None], u]  # [P, src, node]
        # expand u's neighbours in ascending slot order: discovery rank
        # within this expansion is the exclusive prefix count of newly
        # discovered nodes (identical to the scalar queue-append order)
        newly = valid_u[..., None] & adj_u & (ordv == INF_I)
        ni = newly.to(I64)
        offs = torch.cumsum(ni, dim=2) - ni
        prev = torch.where(newly, u[..., None], prev)
        ordv = torch.where(newly, counter[..., None] + offs, ordv)
        counter = counter + ni.sum(dim=2)

    srcs = slot[None, :].expand(P, C)
    route_on = (~is2d)[:, None] & active & (srcs != dest[:, None])
    node = dest[:, None].expand(P, C)
    hops = torch.zeros((P, C), dtype=I64, device=dev)
    hops3 = torch.zeros((P, C), dtype=I64, device=dev)
    n_plane = C * (C - 1) // 2  # link ids >= n_plane are 3D chain bonds
    link_ids = torch.arange(L, device=dev)
    inc_s = torch.zeros((P, C, L), dtype=F64, device=dev)
    for _ in range(C - 1):
        pu = torch.gather(prev, 2, node[..., None])[..., 0]
        go = route_on & (node != srcs) & (pu >= 0)
        lk = lid[rows[:, None], torch.where(go, pu, 0), node]
        inc_s = inc_s + ((link_ids[None, None, :] == lk[..., None])
                         & go[..., None]).to(F64)
        hops = hops + go.to(I64)
        if cfg.hop_uniform is None:
            hops3 = hops3 + (go & (lk >= n_plane)).to(I64)
        node = torch.where(go, pu, node)
    inc = inc_s.transpose(1, 2)  # [P, link, src]

    # -- bonding yield / assembly / carbon rates (Eqs. 15-16, 2) -----------
    n_f = n.to(F64)
    m_f = m_planar.to(F64)
    cl_f = chain_len.to(F64)
    assembly = torch.where(
        is2d, cfg.acost,
        torch.where(is25, n_f * cfg.acost * scale25,
                    torch.where(is3d, n_f * cfg.acost * scale3,
                                m_f * cfg.acost * scale25
                                + cl_f * cfg.acost * scale3)))
    bond_y, p3_bonded = bonding(is2d, is25, is3d, ishyb, n_f, m_f, cl_f, y25,
                                y3, cfp3, torch.where(tmask, a_chain, 0.0))
    pkg_area = torch.where(is2d, areas[:, 0],
                           torch.where(is3d, a_chain[:, 0], bbox))
    return dict(
        eff_bw=eff_bw, dram_e=dram_e, hops=hops, hops3=hops3,
        link_bw=link_bw, link_e=link_e, inc=inc, pkg_area=pkg_area,
        bond_y=bond_y, assembly=assembly, interp=(is25 | ishyb) & interp25,
        p25_rate=torch.where(is25 | ishyb, cfp25, 0.0),
        p3_bonded=p3_bonded, is2d=is2d, dest=dest)
