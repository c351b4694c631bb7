"""Analytical systolic-array timing and traffic model (ScaleSim-equivalent).

The paper evaluates compute latency with the cycle-accurate ScaleSim
simulator and hides its cost behind a lookup cache (Sec. V-D). On this
substrate we use the closed-form formulation that ScaleSim's analytical
mode implements — per-dataflow fill/stream/drain pipeline timing over
array-sized tile passes, plus a buffer-fold DRAM-traffic model — which
preserves the relative trends the paper reports (shape-dependent dataflow
ranking, SRAM-size sensitivity) while being cheap enough to batch.

Conventions: operands are 8-bit (the paper's MAC energy is per 8-bit MAC);
partial sums are 32-bit. The array is square (A x A PEs). The chiplet's
SRAM is split into three equal buffers (ifmap / filter / ofmap), matching
the paper's ScaleSim configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .chiplet import Chiplet
from .techdb import DEFAULT_DB, TechDB
from .workload import Tile

OPERAND_BYTES = 1      # int8 inputs/weights
PSUM_BYTES = 4         # fp32/int32 accumulators


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Cycles and traffic for one core's assigned tile list."""

    cycles: int                 # total compute cycles on the array
    dram_rd_bits: int           # DRAM -> chiplet operand traffic
    dram_wr_bits: int           # chiplet -> DRAM result traffic
    sram_bits: int              # on-chip buffer traffic (reads+writes)
    macs: int                   # useful MACs executed

    def __add__(self, other: "SimResult") -> "SimResult":
        return SimResult(
            self.cycles + other.cycles,
            self.dram_rd_bits + other.dram_rd_bits,
            self.dram_wr_bits + other.dram_wr_bits,
            self.sram_bits + other.sram_bits,
            self.macs + other.macs,
        )


ZERO = SimResult(0, 0, 0, 0, 0)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def simulate_tile(tile: Tile, core: Chiplet, dataflow: str) -> SimResult:
    """Closed-form systolic timing for one (m, k, n) sub-GEMM on an A x A
    array.

    Per dataflow, the stationary operand is pinned in the PEs and the other
    two stream through; a tile pass costs (stream + 2A - 1) cycles of
    fill/stream/drain pipeline:

      OS: outputs stationary. Passes over ceil(m/A) * ceil(n/A) output
          tiles, each streaming the k dimension.
      WS: weights stationary. Passes over ceil(k/A) * ceil(n/A) weight
          tiles, each streaming m input rows.
      IS: inputs stationary. Passes over ceil(m/A) * ceil(k/A) input
          tiles, each streaming n weight columns.
    """
    a = core.array
    m, k, n = tile.m, tile.k, tile.n
    if dataflow == "OS":
        passes = _ceil_div(m, a) * _ceil_div(n, a)
        stream = k
    elif dataflow == "WS":
        passes = _ceil_div(k, a) * _ceil_div(n, a)
        stream = m
    elif dataflow == "IS":
        passes = _ceil_div(m, a) * _ceil_div(k, a)
        stream = n
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    cycles = passes * (stream + 2 * a - 1)
    traffic = _tile_traffic(tile, core, dataflow)
    return SimResult(cycles, traffic[0], traffic[1], traffic[2], tile.macs)


def _tile_traffic(tile: Tile, core: Chiplet, dataflow: str):
    """Buffer-fold DRAM traffic + naive-streaming SRAM traffic (bits).

    The streamed operands are re-fetched from DRAM once per pass over the
    stationary dimension *unless* the relevant strip fits in its third of
    the SRAM, in which case it is read once and re-served from SRAM. The
    ofmap is written once; under WS/IS partial sums spill per K-fold when
    the output strip does not fit on chip.
    """
    a = core.array
    m, k, n = tile.m, tile.k, tile.n
    buf = core.buffer_bytes_each()
    if_bytes = m * k * OPERAND_BYTES
    w_bytes = k * n * OPERAND_BYTES
    of_bytes = m * n * PSUM_BYTES

    final_wr = m * n * OPERAND_BYTES    # outputs requantized for writeback
    if dataflow == "OS":
        # ifmap strip per output-row tile: A x k ; reused across n tiles
        if_folds = 1 if a * k * OPERAND_BYTES <= buf else _ceil_div(n, a)
        w_folds = 1 if k * a * OPERAND_BYTES <= buf else _ceil_div(m, a)
        rd = if_bytes * if_folds + w_bytes * w_folds
        wr = final_wr
    elif dataflow == "WS":
        # weights read once; ifmap column-slice m x A reused across n tiles
        if_folds = 1 if m * a * OPERAND_BYTES <= buf else _ceil_div(n, a)
        k_folds = _ceil_div(k, a)
        psum_spill = 1 if m * a * PSUM_BYTES <= buf else k_folds
        rd = w_bytes + if_bytes * if_folds + of_bytes * (psum_spill - 1)
        wr = of_bytes * (psum_spill - 1) + final_wr
    else:  # IS
        w_folds = 1 if a * n * OPERAND_BYTES <= buf else _ceil_div(m, a)
        k_folds = _ceil_div(k, a)
        psum_spill = 1 if a * n * PSUM_BYTES <= buf else k_folds
        rd = if_bytes + w_bytes * w_folds + of_bytes * (psum_spill - 1)
        wr = of_bytes * (psum_spill - 1) + final_wr
    # SRAM sees the un-folded streaming traffic: every pass streams its
    # operands through the array edge plus result writes.
    sram = (if_bytes + w_bytes + of_bytes) * 8  # bits, one full pass
    sram += (rd + wr) * 8                        # refills mirrored in SRAM
    return rd * 8, wr * 8, sram


def simulate_assignment(
    tiles: Sequence[Tile], core: Chiplet, dataflow: str,
) -> SimResult:
    """Total cycles/traffic for all tiles assigned to one core. Tiles run
    back-to-back on the array (the scheduler serializes per core)."""
    total = ZERO
    for t in tiles:
        total = total + simulate_tile(t, core, dataflow)
    return total


def compute_latency_s(res: SimResult, core: Chiplet, db: TechDB = DEFAULT_DB) -> float:
    """Cycles -> seconds at the node-scaled clock (1 GHz at 7nm [50])."""
    return res.cycles / (core.freq_ghz(db) * 1e9)


# ---------------------------------------------------------------------------
# Simulation cache (Sec V-D): keyed on everything that changes cycle count.
# ---------------------------------------------------------------------------


class SimCache:
    """Lookup-table simulation cache. A full 'simulation' is only run when
    the (tile list, array size, buffer size, dataflow) key is unseen."""

    def __init__(self) -> None:
        self._store = {}
        self.hits = 0
        self.misses = 0

    def key(self, tiles: Sequence[Tile], core: Chiplet, dataflow: str):
        return (
            tuple((t.m, t.k, t.n) for t in tiles),
            core.array, core.sram_kb, dataflow,
        )

    def simulate(self, tiles: Sequence[Tile], core: Chiplet, dataflow: str) -> SimResult:
        k = self.key(tiles, core, dataflow)
        hit = self._store.get(k)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        res = simulate_assignment(tiles, core, dataflow)
        self._store[k] = res
        return res
