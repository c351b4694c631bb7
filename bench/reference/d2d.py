"""Topology-aware die-to-die communication model (Sec IV-A, Eqs. 6-10).

Builds the package topology (floorplan adjacency for 2.5D, a vertical
chain for 3D stacks, the composition for hybrids), assigns per-chiplet
bump budgets from geometry x bump pitch (Eq. 7), derives link bandwidths
as the min of the two endpoints' shares under the protocol's lane rate and
efficiency (Eq. 6), routes every source's reduction traffic to the
destination chiplet along shortest paths with shared links serialized
(Fig. 4), and exposes base-die-mediated DRAM bandwidth for stacked dies
(Eqs. 8-10).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import comm as comm_mod
from . import floorplan as fp
from .chiplet import Chiplet
from .system import HISystem
from .techdb import DEFAULT_DB, DEFAULT_HOP_LATENCY_S, TechDB

# Back-compat alias: the per-hop switch/PHY latency now lives per protocol
# in ``TechDB.protocols[*].hop_latency_s`` (neutral default = this value).
HOP_LATENCY_S = DEFAULT_HOP_LATENCY_S


@dataclasses.dataclass
class Link:
    a: int
    b: int
    bw_bits_s: float          # effective payload bandwidth (Eq. 6 min)
    energy_pj_bit: float
    kind: str                 # "2.5D" | "3D"
    hop_latency_s: float = DEFAULT_HOP_LATENCY_S

    def key(self) -> Tuple[int, int]:
        return (self.a, self.b) if self.a < self.b else (self.b, self.a)


@dataclasses.dataclass
class Topology:
    """Package-level communication graph plus memory attach points."""

    system: HISystem
    links: Dict[Tuple[int, int], Link]
    adj: Dict[int, Set[int]]
    dest: int                                  # reduction destination
    mem_bw_bits_s: Dict[int, float]            # direct DRAM bw per chiplet
    base_die: Optional[int]                    # 3D/hybrid stack base
    floorplan: Optional[fp.Floorplan]
    stack_order: Tuple[int, ...]
    # comm-model payload (repro_torch.core.comm): per-chiplet mean NoC hop
    # counts (empty = legacy model) plus the TechDB NoC knobs, stashed at
    # build time so ``route_reduction`` keeps its db-free signature.
    noc_hops: Tuple[float, ...] = ()
    noc_hop_latency_s: float = 0.0
    noc_energy_pj_bit: float = 0.0
    # shared per-hop D2D latency when every protocol agrees (the default);
    # None switches route_reduction to the per-link hop-latency sum
    hop_latency_uniform: Optional[float] = DEFAULT_HOP_LATENCY_S

    # -- path helpers -------------------------------------------------------

    def shortest_path(self, src: int, dst: int) -> List[int]:
        """BFS with *sorted* neighbour expansion: ties between equal-length
        paths break deterministically (lowest chiplet index first), so the
        scalar and batched evaluators route identically."""
        if src == dst:
            return [src]
        prev: Dict[int, int] = {src: src}
        q = deque([src])
        while q:
            u = q.popleft()
            for v in sorted(self.adj[u]):
                if v not in prev:
                    prev[v] = u
                    if v == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return path[::-1]
                    q.append(v)
        raise RuntimeError(f"no path {src}->{dst}: topology disconnected")

    def path_links(self, src: int, dst: int) -> List[Link]:
        nodes = self.shortest_path(src, dst)
        out = []
        for u, v in zip(nodes, nodes[1:]):
            out.append(self.links[(u, v) if u < v else (v, u)])
        return out

    def min_path_bw(self, src: int, dst: int) -> float:
        """min-bandwidth-of-path semantics (weakest link dominates)."""
        links = self.path_links(src, dst)
        return min(l.bw_bits_s for l in links) if links else float("inf")

    def effective_dram_bw(self, idx: int) -> float:
        """Eqs. 8-10: stacked dies reach DRAM via the base die; effective
        bandwidth is min(DRAM bw, min-bandwidth of the path down). Routed
        through :meth:`min_path_bw` so the two weakest-link semantics
        cannot drift apart."""
        direct = self.mem_bw_bits_s.get(idx, 0.0)
        if direct > 0.0:
            return direct
        assert self.base_die is not None
        return min(self.mem_bw_bits_s[self.base_die],
                   self.min_path_bw(idx, self.base_die))

    def dram_path_hops(self, idx: int) -> int:
        if self.mem_bw_bits_s.get(idx, 0.0) > 0.0:
            return 0
        assert self.base_die is not None
        return len(self.path_links(idx, self.base_die))

    def dram_path_energy_pj_bit(self, idx: int) -> float:
        """Compute-memory D2D energy per bit (3D stacks only)."""
        if self.mem_bw_bits_s.get(idx, 0.0) > 0.0:
            return 0.0
        assert self.base_die is not None
        return sum(l.energy_pj_bit for l in self.path_links(idx, self.base_die))


# ---------------------------------------------------------------------------
# Bump budgets and link bandwidth (Eqs. 6-7)
# ---------------------------------------------------------------------------


def bump_count(ch: Chiplet, pitch_um: float, three_d: bool,
               db: TechDB = DEFAULT_DB) -> int:
    """Eq. 7 (whole-chiplet budget). 3D spreads bumps across the die area;
    2.5D restricts them to the die edges (perimeter), as D2D PHYs demand
    length-matched escape routing clear of the central power grid."""
    if three_d:
        area_um2 = ch.area_mm2(db) * 1e6
        return max(1, int(area_um2 / (pitch_um * pitch_um)))
    perim_um = ch.perimeter_mm(db) * 1e3
    return max(1, int(perim_um / pitch_um))


def link_bump_count(pitch_um: float, *, edge_mm: Optional[float] = None,
                    area_mm2: Optional[float] = None) -> int:
    """Eq. 7 applied per LINK: a 2.5D link only gets the bumps that fit on
    the shared edge between the two neighbouring dies (the topology-aware
    part of the model); a 3D bond gets the full overlapping face area."""
    if area_mm2 is not None:
        return max(1, int(area_mm2 * 1e6 / (pitch_um * pitch_um)))
    assert edge_mm is not None
    return max(1, int(edge_mm * 1e3 / pitch_um))


def chiplet_d2d_bw_bits(ch: Chiplet, pitch_um: float, proto: str,
                        three_d: bool, db: TechDB = DEFAULT_DB) -> float:
    """Eq. 6: BW = DR x N_bump x eta (bits/s), whole-chiplet budget."""
    spec = db.protocols[proto]
    n = bump_count(ch, pitch_um, three_d, db)
    return spec.data_rate_gbps * 1e9 * n * spec.efficiency


def link_bw_bits(proto: str, pitch_um: float, *,
                 edge_mm: Optional[float] = None,
                 area_mm2: Optional[float] = None,
                 db: TechDB = DEFAULT_DB) -> float:
    spec = db.protocols[proto]
    n = link_bump_count(pitch_um, edge_mm=edge_mm, area_mm2=area_mm2)
    return spec.data_rate_gbps * 1e9 * n * spec.efficiency


# ---------------------------------------------------------------------------
# Topology construction
# ---------------------------------------------------------------------------


def build_topology(sys: HISystem, db: TechDB = DEFAULT_DB) -> Topology:
    n = sys.n_chiplets
    areas = [c.area_mm2(db) for c in sys.chiplets]
    dest = max(range(n), key=lambda i: areas[i])
    mem = db.memories[sys.memory]
    total_mem_bw = mem.bw_gbs_per_channel * mem.max_channels * 8e9  # bits/s
    # comm-model payload: NoC hop counts only exist under mesh_noc systems
    # (empty tuple keeps route_reduction on the literal legacy code path)
    comm_kw = dict(
        noc_hops=comm_mod.system_noc_hops(sys) if sys.noc else (),
        noc_hop_latency_s=db.noc_hop_latency_s,
        noc_energy_pj_bit=db.noc_energy_pj_bit,
        hop_latency_uniform=db.uniform_hop_latency(),
    )

    links: Dict[Tuple[int, int], Link] = {}
    adj: Dict[int, Set[int]] = {i: set() for i in range(n)}
    plan: Optional[fp.Floorplan] = None
    base_die: Optional[int] = None
    stack_order: Tuple[int, ...] = ()
    mem_bw: Dict[int, float] = {}

    def add_link(a: int, b: int, pkg_name: str, proto: str, kind: str,
                 edge_mm: Optional[float] = None):
        pkg = db.packages[pkg_name]
        if kind == "3D":
            # face-to-face bond: bumps over the smaller die's full area
            face = min(sys.chiplets[a].area_mm2(db),
                       sys.chiplets[b].area_mm2(db))
            bw = link_bw_bits(proto, pkg.bump_pitch_um, area_mm2=face, db=db)
        else:
            # side-by-side: bumps limited to the shared floorplan edge,
            # capped by either chiplet's whole-perimeter budget (Eq. 6 min)
            assert edge_mm is not None
            bw = link_bw_bits(proto, pkg.bump_pitch_um, edge_mm=edge_mm,
                              db=db)
            bw = min(bw, chiplet_d2d_bw_bits(
                sys.chiplets[a], pkg.bump_pitch_um, proto, False, db))
            bw = min(bw, chiplet_d2d_bw_bits(
                sys.chiplets[b], pkg.bump_pitch_um, proto, False, db))
        spec = db.protocols[proto]
        key = (a, b) if a < b else (b, a)
        links[key] = Link(key[0], key[1], bw, spec.energy_pj_bit, kind,
                          spec.hop_latency_s)
        adj[a].add(b)
        adj[b].add(a)

    if sys.style == "2D":
        mem_bw[0] = total_mem_bw
        return Topology(sys, links, adj, dest, mem_bw, None, None, (),
                        **comm_kw)

    if sys.style in ("2.5D", "2.5D+3D"):
        planar = list(sys.planar_indices())
        if sys.style == "2.5D+3D":
            stack_order = sys.stack_order(db)
            base_die = stack_order[0]
            planar = planar + [base_die]   # stack sits on its base die slot
        plan_areas = [areas[i] for i in planar]
        plan = fp.floorplan(plan_areas)
        # remap floorplan rect indices back to chiplet indices
        for r in plan.rects:
            r.idx = planar[r.idx]
        plan_adj = plan.adjacency()
        rect_of = {r.idx: r for r in plan.rects}
        for a, nbrs in plan_adj.items():
            for b in nbrs:
                if (min(a, b), max(a, b)) not in links:
                    edge = rect_of[a].edge_shared(rect_of[b])
                    add_link(a, b, sys.pkg_25d, sys.proto_25d, "2.5D",
                             edge_mm=edge)
        if sys.style == "2.5D+3D":
            for lo, hi in zip(stack_order, stack_order[1:]):
                add_link(lo, hi, sys.pkg_3d, sys.proto_3d, "3D")
        # 2.5D memory: channels distributed by chiplet size (Sec IV-A(2));
        # stacked non-base dies get no direct channel.
        total_planar_area = sum(areas[i] for i in planar)
        for i in planar:
            mem_bw[i] = total_mem_bw * areas[i] / total_planar_area
    else:  # pure 3D
        stack_order = sys.stack_order(db)
        base_die = stack_order[0]
        for lo, hi in zip(stack_order, stack_order[1:]):
            add_link(lo, hi, sys.pkg_3d, sys.proto_3d, "3D")
        mem_bw[base_die] = total_mem_bw

    return Topology(sys, links, adj, dest, mem_bw, base_die, plan,
                    stack_order, **comm_kw)


# ---------------------------------------------------------------------------
# D2D reduction-phase latency and traffic (Fig. 4 semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class D2DResult:
    latency_s: float
    total_bits: int                       # payload bits crossing any link
    link_bits: Dict[Tuple[int, int], int]
    energy_pj: float
    hops: int


def route_reduction(topo: Topology, src_bits: Sequence[int]) -> D2DResult:
    """Route ``src_bits[i]`` from every chiplet i to the destination.

    Shared links serialize (their loads add); disjoint links proceed in
    parallel, so the reduction-phase latency is the busiest-link time plus
    per-hop overheads along the slowest path: package-level switch/PHY
    hops (per-protocol ``hop_latency_s``; the uniform default collapses
    to the bit-pinned ``max_hops * h``) plus, under the mesh_noc comm
    model, the source and destination chiplets' mean on-die NoC hop
    latencies. NoC router energy is charged per bit-hop alongside the
    link energy — the traffic-proportional router bill.
    """
    link_bits: Dict[Tuple[int, int], int] = {k: 0 for k in topo.links}
    energy = 0.0
    max_hops = 0
    total = 0
    hop_lat = 0.0
    noc_h = topo.noc_hops
    dest_noc = noc_h[topo.dest] if noc_h else 0.0
    uniform = topo.hop_latency_uniform
    for src, bits in enumerate(src_bits):
        if src == topo.dest or bits <= 0:
            continue
        path = topo.path_links(src, topo.dest)
        max_hops = max(max_hops, len(path))
        path_lat = (len(path) * uniform if uniform is not None
                    else sum(l.hop_latency_s for l in path))
        if noc_h:
            pair_hops = noc_h[src] + dest_noc
            path_lat += pair_hops * topo.noc_hop_latency_s
            energy += bits * pair_hops * topo.noc_energy_pj_bit
        hop_lat = max(hop_lat, path_lat)
        for link in path:
            link_bits[link.key()] += bits
            energy += link.energy_pj_bit * bits
            total += bits
    latency = 0.0
    for key, bits in link_bits.items():
        if bits:
            latency = max(latency, bits / topo.links[key].bw_bits_s)
    latency += hop_lat
    return D2DResult(latency, total, link_bits, energy, max_hops)
