"""Encoded design space for CarbonPATH pathfinding (Pathfinder API v2).

The discrete HI design space of Sec V-A — chiplet multiset x integration
style x package interconnect/protocol x memory x mapping — is canonically
enumerated from a :class:`TechDB` and represented as fixed-width ``int32``
vectors so whole populations can be validated, sampled and evaluated as
arrays (see :mod:`repro_torch.pathfinding.batch`).

Vector layout (one row per system, width ``9 + 3 * max_chiplets``)::

    [0] n_chiplets      [1] style_idx     [2] memory_idx
    [3] order           [4] dataflow_idx  [5] split_k
    [6] pair25_idx      (index into valid_pairs_25d(), -1 if none)
    [7] pair3_idx       (index into valid_pairs_3d(),  -1 if none)
    [8] stack_mask      (bitmask of 3D-stacked chiplet indices, 0 if none)
    [9 + 3i .. 11 + 3i] per-chiplet (array_idx, node_idx, sram_idx)
                        for i < n_chiplets; -1 padding beyond.

Under ``comm="mesh_noc"`` (see :mod:`repro_torch.core.comm`) the row grows two
per-chiplet NoC columns appended after the chiplet block (total width
``9 + 5 * max_chiplets``)::

    [noc_col + 2i]      mesh_dims_idx  (index into comm.MESH_DIMS)
    [noc_col + 2i + 1]  entry_idx      (index into comm.ENTRY_PLACEMENTS)
                        for i < n_chiplets; -1 padding beyond.

Under ``schedule="window"`` (see :mod:`repro_torch.core.schedule`) the row
grows two whole-design schedule columns appended after every per-chiplet
block::

    [sched_col]      start_hour (0..23)
    [sched_col + 1]  shape_idx  (index into the SCHEDULE_SHAPES table)

Legacy vectors round-trip unchanged: the NoC columns exist only when the
space's ``comm`` resolves to ``mesh_noc``, the schedule columns only
when ``schedule`` resolves to ``window``. When either model is forced
through its env var (``REPRO_COMM_MODEL`` / ``REPRO_SCHEDULE``) rather
than requested explicitly, the axes are *frozen* at their bit-neutral
``(0, 0)`` values — sampling fills neutral values without consuming RNG
draws and move generators skip the corresponding moves — so legacy
searches replay identically through the widened program.

``encode``/``decode`` round-trip exactly for every valid system (the
stack tuple is canonicalized to sorted order, which is what the SA move
generator produces anyway).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from . import comm as comm_mod
from . import schedule as sched_mod
from .chiplet import Chiplet
from .system import HISystem, is_valid
from .techdb import (
    DATAFLOWS,
    DEFAULT_DB,
    INTEGRATION_STYLES,
    PKG_PROTOCOLS_25D,
    PKG_PROTOCOLS_3D,
    PROTOCOLS_25D,
    TechDB,
    valid_pairs_25d,
    valid_pairs_3d,
)
from .workload import Mapping

# column indices of the encoding
COL_N, COL_STYLE, COL_MEM, COL_ORDER, COL_DATAFLOW, COL_SPLITK = range(6)
COL_PAIR25, COL_PAIR3, COL_STACK = 6, 7, 8
COL_CHIP = 9  # first per-chiplet column

S_2D, S_25D, S_3D, S_HYBRID = range(4)  # indices into INTEGRATION_STYLES


DEFAULT_MAX_CHIPLETS = 6  # paper Sec V-A chiplet-count bound


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Canonical enumeration of the discrete HI space from a TechDB."""

    # TechDB is a mutable (unhashable) dataclass, which Python 3.11+
    # refuses as a plain field default; the factory hands out the same
    # DEFAULT_DB object
    db: TechDB = dataclasses.field(default_factory=lambda: DEFAULT_DB)
    max_chiplets: int = DEFAULT_MAX_CHIPLETS
    # Communication model ("legacy" | "mesh_noc"). None resolves through
    # the REPRO_COMM_MODEL env var (default "legacy"). An env-forced
    # mesh_noc keeps the NoC axes *frozen* at the neutral mesh
    # (noc_live False): legacy searches replay bit-identically through
    # the mesh program. Passing comm="mesh_noc" explicitly makes the
    # axes live search dimensions.
    comm: Optional[str] = None
    # Schedule model ("fixed" | "window"). None resolves through the
    # REPRO_SCHEDULE env var (default "fixed"). Same freeze semantics as
    # comm: env-forced window keeps the (start_hour, shape) axes frozen
    # at the neutral (0, 0) schedule (sched_live False); passing
    # schedule="window" explicitly makes them live search dimensions.
    schedule: Optional[str] = None

    def __post_init__(self):
        db = self.db
        set_ = object.__setattr__
        explicit = self.comm
        set_(self, "comm", comm_mod.resolve_comm(explicit))
        set_(self, "noc_live",
             self.comm == "mesh_noc" and explicit == "mesh_noc")
        explicit_sched = self.schedule
        set_(self, "schedule", sched_mod.resolve_schedule(explicit_sched))
        set_(self, "sched_live",
             self.schedule == "window" and explicit_sched == "window")
        set_(self, "arrays", tuple(db.array_sizes))
        set_(self, "nodes", tuple(db.tech_nodes))
        set_(self, "memories", tuple(db.memories))
        set_(self, "pairs_25d", valid_pairs_25d())
        set_(self, "pairs_3d", valid_pairs_3d())
        set_(self, "array_index", {a: i for i, a in enumerate(self.arrays)})
        set_(self, "node_index", {t: i for i, t in enumerate(self.nodes)})
        set_(self, "memory_index", {m: i for i, m in enumerate(self.memories)})
        set_(self, "dataflow_index", {d: i for i, d in enumerate(DATAFLOWS)})
        set_(self, "style_index",
             {s: i for i, s in enumerate(INTEGRATION_STYLES)})
        set_(self, "pair25_index",
             {p: i for i, p in enumerate(self.pairs_25d)})
        set_(self, "pair3_index", {p: i for i, p in enumerate(self.pairs_3d)})
        set_(self, "sram_index",
             {a: {s: i for i, s in enumerate(db.sram_sizes_kb[a])}
              for a in self.arrays})
        # sram option count per array (vector for validity checks)
        set_(self, "n_sram",
             np.array([len(db.sram_sizes_kb[a]) for a in self.arrays],
                      dtype=np.int32))
        # hierarchical package draw, mirroring sa.random_system: first a
        # package uniform, then a protocol uniform within the package
        set_(self, "pkg25_pairs",
             tuple(tuple(self.pair25_index[(pkg, pr)] for pr in protos)
                   for pkg, protos in PKG_PROTOCOLS_25D.items()))
        set_(self, "pkg3_pairs",
             tuple(tuple(self.pair3_index[(pkg, pr)] for pr in protos)
                   for pkg, protos in PKG_PROTOCOLS_3D.items()))

    # -- flat lookup tables for vectorized (device) hierarchical moves ------

    def move_tables(self) -> dict:
        """Flat ``int32`` tables that let :mod:`repro_torch.pathfinding.device`
        mirror the hierarchical package/protocol draws of
        :func:`repro_torch.core.sa.propose` with pure gathers:

        * ``p25_off``/``p25_cnt``/``p25_flat`` — CSR layout of pair-25D ids
          grouped by package (draw a package uniformly, then a protocol
          uniformly within it);
        * ``pair25_pkg``/``pair25_local``/``pair25_proto`` — reverse maps
          from a pair id to its package, its position within the package
          and its global protocol index;
        * ``pair25_by_pkg_proto`` — pair id for (package, protocol) or -1
          when incompatible (the "keep the protocol if the new package
          supports it" rule of ``_move_package``);
        * ``pair3_pkg``/``pair3_of_pkg`` — the 3D equivalents (every 3D
          package carries exactly UCIe-3D).
        """
        cached = getattr(self, "_move_tables", None)
        if cached is not None:
            return cached
        n25 = len(self.pairs_25d)
        pair_pkg = np.empty(n25, dtype=np.int32)
        pair_local = np.empty(n25, dtype=np.int32)
        pair_proto = np.empty(n25, dtype=np.int32)
        by_pkg_proto = np.full(
            (len(PKG_PROTOCOLS_25D), len(PROTOCOLS_25D)), -1, dtype=np.int32)
        off, cnt, flat = [0], [], []
        for pi, (pkg, protos) in enumerate(PKG_PROTOCOLS_25D.items()):
            for li, proto in enumerate(protos):
                pid = self.pair25_index[(pkg, proto)]
                gp = PROTOCOLS_25D.index(proto)
                pair_pkg[pid] = pi
                pair_local[pid] = li
                pair_proto[pid] = gp
                by_pkg_proto[pi, gp] = pid
                flat.append(pid)
            cnt.append(len(protos))
            off.append(len(flat))
        pair3_pkg = np.empty(len(self.pairs_3d), dtype=np.int32)
        pair3_of_pkg = np.empty(len(PKG_PROTOCOLS_3D), dtype=np.int32)
        for pi, pkg in enumerate(PKG_PROTOCOLS_3D):
            pid = self.pair3_index[(pkg, "UCIe-3D")]
            pair3_pkg[pid] = pi
            pair3_of_pkg[pi] = pid
        tables = dict(
            p25_off=np.asarray(off, dtype=np.int32),
            p25_cnt=np.asarray(cnt, dtype=np.int32),
            p25_flat=np.asarray(flat, dtype=np.int32),
            pair25_pkg=pair_pkg, pair25_local=pair_local,
            pair25_proto=pair_proto, pair25_by_pkg_proto=by_pkg_proto,
            pair3_pkg=pair3_pkg, pair3_of_pkg=pair3_of_pkg,
        )
        object.__setattr__(self, "_move_tables", tables)
        return tables

    # -- geometry -----------------------------------------------------------

    @property
    def width(self) -> int:
        w = COL_CHIP + 3 * self.max_chiplets
        if self.comm == "mesh_noc":
            w += 2 * self.max_chiplets
        if self.schedule == "window":
            w += 2
        return w

    @property
    def noc_col(self) -> int:
        """First NoC column (mesh_noc spaces only)."""
        return COL_CHIP + 3 * self.max_chiplets

    @property
    def sched_col(self) -> int:
        """First schedule column (window spaces only) — after every
        per-chiplet block, so NoC-bearing and legacy layouts both append
        the schedule pair at the tail."""
        col = COL_CHIP + 3 * self.max_chiplets
        if self.comm == "mesh_noc":
            col += 2 * self.max_chiplets
        return col

    def chip_cols(self, i: int):
        base = COL_CHIP + 3 * i
        return base, base + 1, base + 2

    def noc_cols(self, i: int):
        base = self.noc_col + 2 * i
        return base, base + 1

    def chiplet_choices(self) -> int:
        """Distinct chiplets in the library (Table II: 80 by default)."""
        return sum(len(self.db.sram_sizes_kb[a]) for a in self.arrays) * len(
            self.nodes)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-column ``(lo, hi)`` inclusive int bounds of the encoding.

        Loose bounds: every valid row satisfies them, but not every row
        inside them is valid (e.g. the SRAM index bound is the max across
        arrays, and pair/stack columns depend on the style). Useful for
        cheap in-bounds assertions over move-generator outputs — the
        tight check remains :meth:`validity_mask`."""
        lo = np.full(self.width, -1, dtype=np.int64)
        hi = np.empty(self.width, dtype=np.int64)
        hi[COL_N] = self.max_chiplets
        lo[COL_N] = 1
        hi[COL_STYLE] = len(INTEGRATION_STYLES) - 1
        lo[COL_STYLE] = 0
        hi[COL_MEM] = len(self.memories) - 1
        lo[COL_MEM] = 0
        hi[COL_ORDER] = 1
        lo[COL_ORDER] = 0
        hi[COL_DATAFLOW] = len(DATAFLOWS) - 1
        lo[COL_DATAFLOW] = 0
        hi[COL_SPLITK] = 1
        lo[COL_SPLITK] = 0
        hi[COL_PAIR25] = len(self.pairs_25d) - 1
        hi[COL_PAIR3] = len(self.pairs_3d) - 1
        hi[COL_STACK] = (1 << self.max_chiplets) - 1
        lo[COL_STACK] = 0
        n_sram_max = int(self.n_sram.max())
        for i in range(self.max_chiplets):
            ca, ct, cs = self.chip_cols(i)
            hi[ca] = len(self.arrays) - 1
            hi[ct] = len(self.nodes) - 1
            hi[cs] = n_sram_max - 1
        if self.comm == "mesh_noc":
            for i in range(self.max_chiplets):
                cm, ce = self.noc_cols(i)
                hi[cm] = len(comm_mod.MESH_DIMS) - 1
                hi[ce] = len(comm_mod.ENTRY_PLACEMENTS) - 1
        if self.schedule == "window":
            sc = self.sched_col
            lo[sc] = lo[sc + 1] = 0   # whole-design axes: never padded
            hi[sc] = sched_mod.HOURS_PER_DAY - 1
            hi[sc + 1] = sched_mod.n_schedule_shapes() - 1
        return lo, hi

    # -- encode / decode ----------------------------------------------------

    def encode(self, sys: HISystem) -> np.ndarray:
        vec = np.full(self.width, -1, dtype=np.int32)
        n = sys.n_chiplets
        if n > self.max_chiplets:
            raise ValueError(
                f"{n} chiplets exceeds space max_chiplets={self.max_chiplets}")
        vec[COL_N] = n
        vec[COL_STYLE] = self.style_index[sys.style]
        vec[COL_MEM] = self.memory_index[sys.memory]
        vec[COL_ORDER] = sys.mapping.order
        vec[COL_DATAFLOW] = self.dataflow_index[sys.mapping.dataflow]
        vec[COL_SPLITK] = sys.mapping.split_k
        vec[COL_PAIR25] = (self.pair25_index[(sys.pkg_25d, sys.proto_25d)]
                           if sys.pkg_25d else -1)
        vec[COL_PAIR3] = (self.pair3_index[(sys.pkg_3d, sys.proto_3d)]
                          if sys.pkg_3d else -1)
        stack = sys.stack if sys.style == "2.5D+3D" else ()
        vec[COL_STACK] = sum(1 << i for i in stack)
        for i, c in enumerate(sys.chiplets):
            ca, ct, cs = self.chip_cols(i)
            vec[ca] = self.array_index[c.array]
            vec[ct] = self.node_index[c.node]
            vec[cs] = self.sram_index[c.array][c.sram_kb]
        if self.comm == "mesh_noc":
            noc = sys.noc or (comm_mod.NOC_NEUTRAL,) * n
            for i, (mi, ei) in enumerate(noc):
                cm, ce = self.noc_cols(i)
                vec[cm] = mi
                vec[ce] = ei
        elif sys.noc:
            raise ValueError(
                "system carries NoC assignments but the space is "
                "comm='legacy'; build the DesignSpace with comm='mesh_noc'")
        if self.schedule == "window":
            sched = sys.schedule or sched_mod.SCHED_NEUTRAL
            sc = self.sched_col
            vec[sc], vec[sc + 1] = sched
        elif sys.schedule is not None:
            raise ValueError(
                "system carries a schedule but the space is "
                "schedule='fixed'; build the DesignSpace with "
                "schedule='window'")
        return vec

    def encode_many(self, systems: Sequence[HISystem]) -> np.ndarray:
        out = np.empty((len(systems), self.width), dtype=np.int32)
        for i, s in enumerate(systems):
            out[i] = self.encode(s)
        return out

    def decode(self, vec: np.ndarray) -> HISystem:
        vec = np.asarray(vec)
        n = int(vec[COL_N])
        style = INTEGRATION_STYLES[int(vec[COL_STYLE])]
        chips = []
        for i in range(n):
            ca, ct, cs = self.chip_cols(i)
            array = self.arrays[int(vec[ca])]
            chips.append(Chiplet(array, self.nodes[int(vec[ct])],
                                 self.db.sram_sizes_kb[array][int(vec[cs])]))
        pkg25 = proto25 = pkg3 = proto3 = None
        if int(vec[COL_PAIR25]) >= 0:
            pkg25, proto25 = self.pairs_25d[int(vec[COL_PAIR25])]
        if int(vec[COL_PAIR3]) >= 0:
            pkg3, proto3 = self.pairs_3d[int(vec[COL_PAIR3])]
        mask = int(vec[COL_STACK])
        stack = tuple(i for i in range(n) if (mask >> i) & 1)
        noc = ()
        if self.comm == "mesh_noc":
            noc = tuple((int(vec[self.noc_col + 2 * i]),
                         int(vec[self.noc_col + 2 * i + 1]))
                        for i in range(n))
        schedule = None
        if self.schedule == "window":
            sc = self.sched_col
            schedule = (int(vec[sc]), int(vec[sc + 1]))
        return HISystem(
            chiplets=tuple(chips),
            style=style,
            memory=self.memories[int(vec[COL_MEM])],
            mapping=Mapping(int(vec[COL_ORDER]),
                            DATAFLOWS[int(vec[COL_DATAFLOW])],
                            int(vec[COL_SPLITK])),
            pkg_25d=pkg25, proto_25d=proto25,
            pkg_3d=pkg3, proto_3d=proto3,
            stack=stack,
            noc=noc,
            schedule=schedule,
        )

    def decode_many(self, batch: np.ndarray) -> List[HISystem]:
        return [self.decode(row) for row in np.asarray(batch)]

    # -- vectorized validity (Sec V-A feasibility rules) --------------------

    def validity_mask(self, batch: np.ndarray) -> np.ndarray:
        """Boolean mask of rows that encode *valid* systems — the batched
        rendering of :func:`repro_torch.core.system.validate`."""
        v = np.atleast_2d(np.asarray(batch, dtype=np.int64))
        n, style = v[:, COL_N], v[:, COL_STYLE]
        p25, p3, stack = v[:, COL_PAIR25], v[:, COL_PAIR3], v[:, COL_STACK]

        ok = (n >= 1) & (n <= self.max_chiplets)
        ok &= (style >= 0) & (style < len(INTEGRATION_STYLES))
        ok &= (v[:, COL_MEM] >= 0) & (v[:, COL_MEM] < len(self.memories))
        ok &= (v[:, COL_ORDER] >= 0) & (v[:, COL_ORDER] <= 1)
        ok &= (v[:, COL_DATAFLOW] >= 0) & (v[:, COL_DATAFLOW] < len(DATAFLOWS))
        ok &= (v[:, COL_SPLITK] >= 0) & (v[:, COL_SPLITK] <= 1)

        for i in range(self.max_chiplets):
            ca, ct, cs = self.chip_cols(i)
            active = i < n
            a, t, s = v[:, ca], v[:, ct], v[:, cs]
            a_ok = (a >= 0) & (a < len(self.arrays))
            chip_ok = (a_ok & (t >= 0) & (t < len(self.nodes)) & (s >= 0)
                       & (s < self.n_sram[np.where(a_ok, a, 0)]))
            ok &= np.where(active, chip_ok, True)

        if self.comm == "mesh_noc":
            for i in range(self.max_chiplets):
                cm, ce = self.noc_cols(i)
                m, e = v[:, cm], v[:, ce]
                noc_ok = ((m >= 0) & (m < len(comm_mod.MESH_DIMS))
                          & (e >= 0) & (e < len(comm_mod.ENTRY_PLACEMENTS)))
                ok &= np.where(i < n, noc_ok, True)

        if self.schedule == "window":
            sc = self.sched_col
            st, sh = v[:, sc], v[:, sc + 1]
            ok &= ((st >= 0) & (st < sched_mod.HOURS_PER_DAY)
                   & (sh >= 0) & (sh < sched_mod.n_schedule_shapes()))

        popcount = sum((stack >> i) & 1 for i in range(self.max_chiplets))
        no3d, no25d, nostack = p3 == -1, p25 == -1, stack == 0
        has25 = (p25 >= 0) & (p25 < len(self.pairs_25d))
        has3 = (p3 >= 0) & (p3 < len(self.pairs_3d))
        in_range = stack < (1 << np.minimum(n, 63))

        ok &= np.where(style == S_2D, (n == 1) & no25d & no3d & nostack, True)
        ok &= np.where(style == S_25D, (n >= 2) & has25 & no3d & nostack, True)
        ok &= np.where(style == S_3D, (n >= 2) & has3 & no25d & nostack, True)
        ok &= np.where(style == S_HYBRID,
                       (n >= 3) & has25 & has3 & (popcount >= 2)
                       & (popcount < n) & in_range & (stack >= 0), True)
        return ok

    # -- batched random sampling -------------------------------------------

    def sample(self, count: int,
               key: Union[int, np.random.Generator] = 0) -> np.ndarray:
        """Draw ``count`` random *valid* encoded systems.

        Mirrors :func:`repro_torch.core.sa.random_system`'s hierarchical draw
        (uniform chiplet count -> style for that count -> package uniform,
        protocol uniform within the package) but vectorized: systems are
        valid by construction, no rejection loop.
        """
        rng = (key if isinstance(key, np.random.Generator)
               else np.random.default_rng(key))
        C = self.max_chiplets
        v = np.full((count, self.width), -1, dtype=np.int32)

        n = rng.integers(1, C + 1, count)
        # style per count: n=1 -> 2D; n=2 -> {2.5D, 3D}; n>=3 -> all three
        style = np.where(
            n == 1, S_2D,
            np.where(n == 2, rng.integers(S_25D, S_3D + 1, count),
                     rng.integers(S_25D, S_HYBRID + 1, count)))
        v[:, COL_N] = n
        v[:, COL_STYLE] = style
        v[:, COL_MEM] = rng.integers(0, len(self.memories), count)
        v[:, COL_ORDER] = rng.integers(0, 2, count)
        v[:, COL_DATAFLOW] = rng.integers(0, len(DATAFLOWS), count)
        v[:, COL_SPLITK] = rng.integers(0, 2, count)

        v[:, COL_PAIR25] = np.where(
            (style == S_25D) | (style == S_HYBRID),
            self._draw_pairs(rng, self.pkg25_pairs, count), -1)
        v[:, COL_PAIR3] = np.where(
            (style == S_3D) | (style == S_HYBRID),
            self._draw_pairs(rng, self.pkg3_pairs, count), -1)

        # chiplets: uniform (array, node, sram-option) per active slot
        a = rng.integers(0, len(self.arrays), (count, C))
        t = rng.integers(0, len(self.nodes), (count, C))
        s = (rng.random((count, C))
             * self.n_sram[a]).astype(np.int32)  # uniform over options
        active = np.arange(C)[None, :] < n[:, None]
        for i in range(C):
            ca, ct, cs = self.chip_cols(i)
            v[:, ca] = np.where(active[:, i], a[:, i], -1)
            v[:, ct] = np.where(active[:, i], t[:, i], -1)
            v[:, cs] = np.where(active[:, i], s[:, i], -1)

        # hybrid stacks: size uniform in [2, n-1], members uniform
        hyb = style == S_HYBRID
        size = np.where(n > 2, 2 + (rng.random(count)
                                    * np.maximum(n - 2, 1)).astype(np.int64),
                        2)
        scores = rng.random((count, C))
        scores[~active] = np.inf
        picked_order = np.argsort(scores, axis=1)
        ranks = np.empty_like(picked_order)
        np.put_along_axis(ranks, picked_order,
                          np.arange(C)[None, :].repeat(count, 0), axis=1)
        member = (ranks < size[:, None]).astype(np.int64)
        mask = (member << np.arange(C)[None, :]).sum(axis=1)
        v[:, COL_STACK] = np.where(hyb, mask, 0)

        if self.comm == "mesh_noc":
            if self.noc_live:
                # live axes: uniform (mesh_dims, entry) per active slot
                m = rng.integers(0, len(comm_mod.MESH_DIMS), (count, C))
                e = rng.integers(0, len(comm_mod.ENTRY_PLACEMENTS),
                                 (count, C))
            else:
                # frozen (env-forced) axes: neutral mesh, no RNG draws,
                # so the legacy sampling stream is untouched
                m = np.zeros((count, C), dtype=np.int64)
                e = np.zeros((count, C), dtype=np.int64)
            for i in range(C):
                cm, ce = self.noc_cols(i)
                v[:, cm] = np.where(active[:, i], m[:, i], -1)
                v[:, ce] = np.where(active[:, i], e[:, i], -1)

        if self.schedule == "window":
            sc = self.sched_col
            if self.sched_live:
                # live axes: uniform (start_hour, shape) per design
                v[:, sc] = rng.integers(0, sched_mod.HOURS_PER_DAY, count)
                v[:, sc + 1] = rng.integers(
                    0, sched_mod.n_schedule_shapes(), count)
            else:
                # frozen (env-forced) axes: neutral always-on schedule,
                # no RNG draws, so the legacy sampling stream is untouched
                v[:, sc] = 0
                v[:, sc + 1] = 0
        return v

    @staticmethod
    def _draw_pairs(rng, pkg_pairs, count: int) -> np.ndarray:
        pkg = rng.integers(0, len(pkg_pairs), count)
        out = np.empty(count, dtype=np.int64)
        for i, protos in enumerate(pkg_pairs):
            sel = pkg == i
            out[sel] = np.asarray(protos)[
                rng.integers(0, len(protos), int(sel.sum()))]
        return out

    def sample_systems(self, count: int,
                       key: Union[int, np.random.Generator] = 0
                       ) -> List[HISystem]:
        return self.decode_many(self.sample(count, key))

    def is_valid_scalar(self, sys: HISystem) -> bool:
        return is_valid(sys, self.db, self.max_chiplets)
