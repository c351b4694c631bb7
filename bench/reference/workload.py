"""GEMM workloads (Table IV) and the workload tiler/assigner (Algorithm 1).

A workload is an (M, K, N) GEMM. Algorithm 1 partitions it into tiles using
base tile sizes (t_M, t_K, t_N) — K is only partitioned when *split-K* is
enabled — and assigns contiguous tile ranges to cores proportionally to
their relative compute throughput, in ascending or descending core order
(*assigning order*).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .chiplet import Chiplet
from .techdb import DEFAULT_DB, TechDB


@dataclasses.dataclass(frozen=True)
class GEMMWorkload:
    name: str
    M: int  # batch dimension
    K: int  # input / reduction dimension
    N: int  # output dimension

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.macs


# Table IV
WORKLOADS: Tuple[GEMMWorkload, ...] = (
    GEMMWorkload("WL1-GPT2-MLP", 512, 768, 3072),
    GEMMWorkload("WL2-ViT-MLP-b32", 6304, 768, 3072),
    GEMMWorkload("WL3-ViT-MLP-b1", 197, 768, 3072),
    GEMMWorkload("WL4-ResNet50-FC", 128, 2048, 1000),
    GEMMWorkload("WL5-VGG16-FC", 64, 4096, 4096),
    GEMMWorkload("WL6-MobileNetV2", 1316, 24, 144),
)


def workload(idx_or_name) -> GEMMWorkload:
    if isinstance(idx_or_name, int):
        return WORKLOADS[idx_or_name - 1]
    for wl in WORKLOADS:
        if wl.name == idx_or_name or wl.name.startswith(str(idx_or_name)):
            return wl
    raise KeyError(idx_or_name)


@dataclasses.dataclass(frozen=True)
class Tile:
    """One (m, k, n) tile of the GEMM; ``partial`` marks split-K tiles whose
    output is a partial sum that must be reduced on the destination core."""

    m: int
    k: int
    n: int
    partial: bool

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


@dataclasses.dataclass(frozen=True)
class Mapping:
    """The paper's O-D-K workload-mapping triple."""

    order: int        # 0 = largest-first, 1 = smallest-first (s_A)
    dataflow: str     # OS | WS | IS
    split_k: int      # 0 | 1

    @property
    def name(self) -> str:
        return f"{self.order}-{self.dataflow}-{self.split_k}"

    @classmethod
    def parse(cls, name: str) -> "Mapping":
        o, d, k = name.split("-")
        return cls(int(o), d, int(k))


ALL_MAPPINGS: Tuple[Mapping, ...] = tuple(
    Mapping(o, d, k) for o in (0, 1) for d in ("OS", "WS", "IS") for k in (0, 1)
)  # 12 strategies (Sec V-A)

# Default base tile sizes. Large enough that cross-tile DRAM re-fetch
# amplification stays low (the buffer-fold model handles within-tile
# reuse), small enough that Table-IV workloads still produce more tiles
# than cores; configurable per call.
DEFAULT_TILE = (512, 512, 512)  # (t_M, t_K, t_N)


def _partition(total: int, base: int) -> List[int]:
    """Split ``total`` into chunks of ``base``; the last chunk absorbs the
    remainder (Algorithm 1 line 3: last tiles may exceed base size)."""
    if total <= base:
        return [total]
    count = total // base
    sizes = [base] * count
    rem = total - base * count
    if rem:
        sizes[-1] += rem
    return sizes


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Tile assignment for one core: the core and its tile list."""

    core: Chiplet
    tiles: Tuple[Tile, ...]

    @property
    def macs(self) -> int:
        return sum(t.macs for t in self.tiles)


def tile_and_assign(
    wl: GEMMWorkload,
    cores: Sequence[Chiplet],
    mapping: Mapping,
    tile_sizes: Tuple[int, int, int] = DEFAULT_TILE,
    db: TechDB = DEFAULT_DB,
) -> List[Assignment]:
    """Algorithm 1: partition (M, K, N) into tiles and assign proportionally
    to core compute power, in the order dictated by ``mapping.order``.

    Returns one :class:`Assignment` per core, in the *original* core order
    (so callers can zip against their chiplet list).
    """
    t_m, t_k, t_n = tile_sizes
    b_m, b_n = t_m, t_n
    # line 1; when split-K is on, force at least two K-slices (a base size
    # above K/2 would silently de-activate the split)
    b_k = min(t_k, max(1, wl.K // 2)) if mapping.split_k else wl.K

    order = sorted(
        range(len(cores)),
        key=lambda i: cores[i].compute_power_ratio(db),
        reverse=not mapping.order,                               # line 2
    )

    ms = _partition(wl.M, b_m)                                   # line 3
    ks = _partition(wl.K, b_k)
    ns = _partition(wl.N, b_n)
    split = len(ks) > 1
    tiles = [
        Tile(m, k, n, partial=split)
        for m in ms for k in ks for n in ns                      # line 4
    ]
    total = len(tiles)

    powers = [cores[i].compute_power_ratio(db) for i in order]
    # a sequential fold in sorted order: the built-in sum() compensates
    # its rounding from Python 3.12 on, which moves ulp-level ties of
    # the fractional parts below (equal-power cores)
    psum = 0.0
    for p in powers:
        psum = psum + p
    ideal = [p / psum * total for p in powers]                   # line 6
    counts = [int(x) for x in ideal]                             # line 7
    remaining = total - sum(counts)
    # line 9: largest fractional parts get the leftovers
    frac_order = sorted(
        range(len(order)), key=lambda i: ideal[i] - counts[i], reverse=True)
    for i in frac_order[:remaining]:
        counts[i] += 1

    assignments: List[Assignment] = [None] * len(cores)          # type: ignore
    start = 0                                                    # lines 10-14
    for pos, core_idx in enumerate(order):
        n_tiles = counts[pos]
        assignments[core_idx] = Assignment(
            cores[core_idx], tuple(tiles[start:start + n_tiles]))
        start += n_tiles
    return assignments


def destination_index(cores: Sequence[Chiplet], db: TechDB = DEFAULT_DB) -> int:
    """The paper designates the largest chiplet as the reduction destination
    (greatest compute capacity and memory bandwidth)."""
    return max(range(len(cores)), key=lambda i: cores[i].area_mm2(db))
