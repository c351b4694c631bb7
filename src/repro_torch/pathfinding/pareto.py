"""Pareto-frontier archive for the torch search engine.

The counterpart of the archive half of :mod:`repro.pathfinding.pareto`:

* :func:`non_dominated_mask` / :func:`non_dominated_mask_torch` — exact
  host reference and vectorized torch renderings of the non-dominated
  (minimization) filter. Both use exact float comparisons, so they agree
  exactly on any input.
* :class:`ParetoArchive` — a bounded archive of non-dominated
  ``(encoded design, objective vector)`` pairs over the
  :data:`repro_torch.core.sa.OBJECTIVE_AXES` axes ``(latency_s, dollar,
  total_cfp)``. Inserts are chunked, storage order is canonical
  (lexicographic), duplicates are dropped, and the archive is pruned to
  ``max_size`` by NSGA-II crowding distance — all deterministic.
* :func:`hypervolume` — exact 2-D/3-D dominated hypervolume w.r.t. a
  reference point.
* :class:`FrontierFeed` — buffered inserts for the host strategies.
* :class:`ScalarizationSweep` — K scalarization directions (from
  :func:`simplex_directions`) x N parallel-tempering chains in one run
  of the torch tempering engine: per-chain Eq. 17 weight rows and a
  replica-exchange pair mask keep each direction's ladder independent.
  Every evaluation feeds the archive, so one call maps the frontier.

* :class:`ScenarioSweep` — the frontier across deployment regions and
  workloads: the whole (workload x region) grid as one stacked
  population of the :class:`~repro_torch.pathfinding.device.
  ScenarioEngine`, with :class:`Scenario` cells, a
  :class:`ScenarioFrontier` result and the per-cell key
  :func:`fold_cell_key`.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DeviceLike, random as trandom, resolve_device
from repro_torch.core.regions import Region, RegionLike, as_region
from repro_torch.core.sa import OBJECTIVE_AXES, random_system
from repro_torch.core.techdb import DEFAULT_DB, TechDB
from repro_torch.core.templates import TEMPLATES, Template
from repro_torch.core.workload import GEMMWorkload
from repro_torch.pathfinding.space import DesignSpace
from repro_torch.runtime import trace

N_AXES = len(OBJECTIVE_AXES)

# pairwise-filter block size: chunked inserts keep the O(n^2) dominance
# comparison bounded at (chunk + max_size)^2 regardless of how many
# samples a sweep feeds in; total work scales as n_samples * chunk, so
# smaller chunks are *cheaper* for bulk feeds (each chunk is pre-filtered
# on its own before the merge — search batches are mostly dominated)
_INSERT_CHUNK = 512


# ---------------------------------------------------------------------------
# Non-dominated filtering: exact host reference + vectorized torch rendering
# ---------------------------------------------------------------------------


def non_dominated_mask(points: np.ndarray) -> np.ndarray:
    """Exact host reference: boolean mask of non-dominated rows.

    Minimization on every axis. Row ``j`` is dominated iff some row ``i``
    is <= on all axes and < on at least one; exact duplicates do not
    dominate each other (both survive — dedup is the archive's job)."""
    p = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if p.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    le = np.all(p[:, None, :] <= p[None, :, :], axis=2)   # i <= j per pair
    lt = np.any(p[:, None, :] < p[None, :, :], axis=2)    # i < j somewhere
    return ~(le & lt).any(axis=0)


def non_dominated_mask_torch(points, torch_device: DeviceLike = None
                             ) -> np.ndarray:
    """Vectorized torch non-dominated filter on ``torch_device``
    (``None`` = cuda).

    Same exact float64 comparisons as :func:`non_dominated_mask`, so the
    two agree bit-for-bit on any front. Supports leading batch
    dimensions: ``[..., n, d] -> [..., n]``."""
    p = torch.as_tensor(np.asarray(points, dtype=np.float64),
                        device=resolve_device(torch_device))
    if p.shape[-2] == 0:
        return np.zeros(p.shape[:-1], dtype=bool)
    le = torch.all(p[..., :, None, :] <= p[..., None, :, :], dim=-1)
    lt = torch.any(p[..., :, None, :] < p[..., None, :, :], dim=-1)
    return (~torch.any(le & lt, dim=-2)).cpu().numpy()


def crowding_distance(points: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance per row (boundary rows get ``inf``).

    Deterministic: per-axis sorting is stable, so exact ties contribute
    identically regardless of input order."""
    p = np.atleast_2d(np.asarray(points, dtype=np.float64))
    n, d = p.shape
    dist = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for a in range(d):
        order = np.argsort(p[:, a], kind="stable")
        v = p[order, a]
        span = v[-1] - v[0]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0:
            gaps = (v[2:] - v[:-2]) / span
            np.add.at(dist, order[1:-1], gaps)
    return dist


def hypervolume(points: np.ndarray, ref: Sequence[float]) -> float:
    """Exact dominated hypervolume (minimization) w.r.t. ``ref``.

    Supports 1/2/3 objectives — 3-D uses slicing along the last axis
    (each z-slab contributes its active points' 2-D area). Points not
    strictly better than ``ref`` on every axis contribute nothing."""
    p = np.atleast_2d(np.asarray(points, dtype=np.float64))
    r = np.asarray(ref, dtype=np.float64)
    if p.shape[0] == 0:
        return 0.0
    p = p[np.all(p < r, axis=1)]
    if p.shape[0] == 0:
        return 0.0
    d = p.shape[1]
    if d == 1:
        return float(r[0] - p[:, 0].min())
    if d == 2:
        return _hv2(p, r)
    if d == 3:
        order = np.argsort(p[:, 2], kind="stable")
        p = p[order]
        zs = np.unique(p[:, 2])
        uppers = np.append(zs[1:], r[2])
        hv = 0.0
        for z, hi in zip(zs, uppers):
            hv += _hv2(p[p[:, 2] <= z, :2], r[:2]) * (hi - z)
        return float(hv)
    raise NotImplementedError(f"hypervolume supports <= 3 axes, got {d}")


def _hv2(p: np.ndarray, r: np.ndarray) -> float:
    """2-D dominated area: sweep x ascending with a falling y staircase."""
    p = p[np.lexsort((p[:, 1], p[:, 0]))]
    hv, y_best = 0.0, r[1]
    for x, y in p:
        if y < y_best:
            hv += (r[0] - x) * (y_best - y)
            y_best = y
    return float(hv)


def simplex_directions(k: int, d: int = N_AXES) -> np.ndarray:
    """``k`` deterministic weight directions on the ``d``-simplex.

    Simplex-lattice design: the smallest resolution ``H`` whose lattice
    has >= ``k`` points, thinned to exactly ``k`` by even index spacing
    (lexicographic order), so every call with the same ``k`` returns the
    same spread — corners (single-objective directions) always included."""
    if k < 1:
        raise ValueError(f"need k >= 1 directions, got {k}")
    h = 1
    while _lattice_size(h, d) < k:
        h += 1
    grid = np.array([c for c in _lattice(h, d)], dtype=np.float64) / h
    idx = np.unique(np.round(np.linspace(0, len(grid) - 1, k)).astype(int))
    # rounding collisions can drop below k: backfill with unused indices
    if len(idx) < k:
        unused = np.setdiff1d(np.arange(len(grid)), idx)
        idx = np.sort(np.concatenate([idx, unused[:k - len(idx)]]))
    return grid[idx]


def _lattice_size(h: int, d: int) -> int:
    from math import comb

    return comb(h + d - 1, d - 1)


def _lattice(h: int, d: int):
    if d == 1:
        yield (h,)
        return
    for i in range(h + 1):
        for rest in _lattice(h - i, d - 1):
            yield (i,) + rest


# ---------------------------------------------------------------------------
# The archive
# ---------------------------------------------------------------------------


class ParetoArchive:
    """Bounded deterministic archive of non-dominated designs.

    Stores ``(encoded row, objective vector)`` pairs; every insert
    re-filters to the non-dominated set (``backend="torch"`` uses the
    vectorized filter on ``torch_device``, ``"numpy"`` the exact host
    reference — they agree exactly), drops duplicate rows, prunes to ``max_size`` by largest
    crowding distance (stable index tie-break) and canonicalizes storage
    to lexicographic ``(vector, encoding)`` order.

    Determinism: the same insert sequence always yields the identical
    archive, re-inserting the archive into itself is a no-op, and while
    the bound is not hit the contents are independent of insertion order
    entirely. Once crowding pruning engages, chunked feeds may retain a
    (deterministic) subset that differs from a single-shot insert —
    pruning is greedy and pruned points cannot return."""

    def __init__(self, max_size: int = 256, n_axes: int = N_AXES,
                 width: Optional[int] = None, backend: str = "numpy",
                 torch_device: DeviceLike = None):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.max_size = max_size
        self.n_axes = n_axes
        self.backend = backend
        self.torch_device = torch_device
        self._vec = np.zeros((0, n_axes), dtype=np.float64)
        self._enc = np.zeros((0, 0 if width is None else width),
                             dtype=np.int32)

    # -- views --------------------------------------------------------------

    def __len__(self) -> int:
        return self._vec.shape[0]

    def __repr__(self) -> str:
        return (f"ParetoArchive(size={len(self)}/{self.max_size}, "
                f"axes={OBJECTIVE_AXES[:self.n_axes]})")

    @property
    def vectors(self) -> np.ndarray:
        """``[m, n_axes]`` objective vectors, canonical order."""
        return self._vec.copy()

    @property
    def encoded(self) -> np.ndarray:
        """``[m, width]`` encoded design rows, canonical order."""
        return self._enc.copy()

    def systems(self, space: DesignSpace) -> List:
        return space.decode_many(self._enc)

    # -- mutation -----------------------------------------------------------

    @trace.spanned("pf.archive.insert")
    def insert(self, encoded: np.ndarray, vectors: np.ndarray) -> int:
        """Insert a batch; returns the archive size afterwards."""
        enc = np.atleast_2d(np.asarray(encoded, dtype=np.int32))
        vec = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
        if enc.shape[0] != vec.shape[0]:
            raise ValueError(
                f"{enc.shape[0]} encodings vs {vec.shape[0]} vectors")
        if vec.shape[1] != self.n_axes:
            raise ValueError(
                f"expected {self.n_axes} axes, got {vec.shape[1]}")
        if self._enc.shape[1] == 0 and enc.shape[1] > 0:
            self._enc = np.zeros((0, enc.shape[1]), dtype=np.int32)
        if enc.shape[1] != self._enc.shape[1]:
            raise ValueError(
                f"row width {enc.shape[1]} != archive {self._enc.shape[1]}")
        for lo in range(0, enc.shape[0], _INSERT_CHUNK):
            self._insert_chunk(enc[lo:lo + _INSERT_CHUNK],
                               vec[lo:lo + _INSERT_CHUNK])
        return len(self)

    def merge(self, other: "ParetoArchive") -> int:
        return self.insert(other._enc, other._vec)

    def _mask(self, vec: np.ndarray) -> np.ndarray:
        if self.backend == "torch":
            return non_dominated_mask_torch(vec, self.torch_device)
        return non_dominated_mask(vec)

    def _insert_chunk(self, enc: np.ndarray, vec: np.ndarray) -> None:
        if vec.shape[0] > 64:
            # pre-reduce the incoming block alone: dominated rows can
            # never enter the archive, and dropping them first keeps the
            # merge pairwise tiny
            pre = self._mask(vec)
            enc, vec = enc[pre], vec[pre]
        all_enc = np.vstack([self._enc, enc])
        all_vec = np.vstack([self._vec, vec])
        # canonical order + exact-duplicate dedup in one pass (int32
        # encodings are exact in float64, so the combined key is lossless)
        key = np.hstack([all_vec, all_enc.astype(np.float64)])
        # np.unique returns first-occurrence indices in sorted-key order:
        # dedup + canonical lexicographic order in one pass
        _, uniq = np.unique(key, axis=0, return_index=True)
        all_enc, all_vec = all_enc[uniq], all_vec[uniq]
        mask = self._mask(all_vec)
        all_enc, all_vec = all_enc[mask], all_vec[mask]
        if all_vec.shape[0] > self.max_size:
            cd = crowding_distance(all_vec)
            keep = np.argsort(-cd, kind="stable")[:self.max_size]
            keep.sort()
            all_enc, all_vec = all_enc[keep], all_vec[keep]
        self._enc, self._vec = all_enc, all_vec

    # -- checkpointing ------------------------------------------------------
    # the repro.checkpoint protocol: archives ride inside checkpoint
    # pytrees as first-class objects (their row count is elastic across
    # restore, so a resumed search continues the exact frontier)

    def checkpoint_arrays(self) -> Dict[str, np.ndarray]:
        """The archive's full state as plain arrays (row widths and
        counts are restored from the checkpoint, not the template).

        Returns references, not copies: mutation always rebinds
        ``_enc``/``_vec`` wholesale (see ``_insert_chunk``), so a
        returned snapshot can never be corrupted in place."""
        return {"enc": self._enc, "vec": self._vec}

    def from_checkpoint_arrays(self, arrays: Dict[str, np.ndarray]
                               ) -> "ParetoArchive":
        """New archive with this one's bounds/backend and the saved
        contents (the restore half of the checkpoint protocol)."""
        out = ParetoArchive(max_size=self.max_size, n_axes=self.n_axes,
                            backend=self.backend,
                            torch_device=self.torch_device)
        out.load_checkpoint_arrays(arrays)
        return out

    def load_checkpoint_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Overwrite contents in place from :meth:`checkpoint_arrays`."""
        enc = np.atleast_2d(np.asarray(arrays["enc"], dtype=np.int32))
        vec = np.atleast_2d(np.asarray(arrays["vec"], dtype=np.float64))
        if enc.shape[0] != vec.shape[0]:
            raise ValueError(
                f"{enc.shape[0]} encodings vs {vec.shape[0]} vectors")
        self._enc, self._vec = enc, vec

    # -- analysis -----------------------------------------------------------

    def reference_point(self, margin: float = 0.1) -> np.ndarray:
        """Nadir + ``margin`` * range per axis (a usable default HV ref)."""
        if len(self) == 0:
            return np.ones(self.n_axes)
        lo, hi = self._vec.min(axis=0), self._vec.max(axis=0)
        span = np.where(hi > lo, hi - lo, np.maximum(np.abs(hi), 1.0))
        return hi + margin * span

    def hypervolume(self, ref: Optional[Sequence[float]] = None) -> float:
        return hypervolume(self._vec,
                           self.reference_point() if ref is None else ref)

    def project(self, axes: Sequence[int]) -> np.ndarray:
        """Re-filtered 2-D (or 1-D) front over a subset of axes — e.g.
        ``project((1, 2))`` is the Fig. 13 CFP-vs-cost frontier."""
        sub = self._vec[:, list(axes)]
        return sub[non_dominated_mask(sub)]


class FrontierFeed:
    """Buffered (encoded, vector) accumulator in front of an archive.

    Scalar strategies evaluate one candidate at a time; inserting rows
    singly would re-run the dominance filter per evaluation. The feed
    buffers rows and flushes in blocks. ``size=0`` disables collection
    (``archive`` stays ``None``)."""

    def __init__(self, size: int = 256, chunk: int = 512):
        self.archive = ParetoArchive(max_size=size) if size > 0 else None
        self._enc: List[np.ndarray] = []
        self._vec: List[np.ndarray] = []
        self._chunk = chunk
        self._pending = 0

    def add(self, encoded: np.ndarray, vectors: np.ndarray) -> None:
        if self.archive is None:
            return
        enc = np.atleast_2d(np.asarray(encoded, dtype=np.int32))
        self._enc.append(enc)
        self._vec.append(np.atleast_2d(np.asarray(vectors)))
        self._pending += enc.shape[0]
        if self._pending >= self._chunk:
            self._flush()

    def _flush(self) -> None:
        if self._pending:
            self.archive.insert(np.vstack(self._enc), np.vstack(self._vec))
            self._enc, self._vec, self._pending = [], [], 0

    def done(self) -> Optional[ParetoArchive]:
        if self.archive is not None:
            self._flush()
        return self.archive




# ---------------------------------------------------------------------------
# ScalarizationSweep: K directions x N chains in one tempering run
# ---------------------------------------------------------------------------


def directions_to_weights(w3: np.ndarray) -> np.ndarray:
    """Map ``[K, 3]`` (latency, cost, CFP) simplex directions to ``[K, 6]``
    Eq. 17 weight rows (METRIC_FIELDS order): latency -> gamma, dollar ->
    theta, and the CFP weight applied in full to both zeta (embodied) and
    eta (operational) — total CFP is their sum; energy/area weights stay
    0 so the scalarization moves only along the frontier axes."""
    w3 = np.atleast_2d(np.asarray(w3, dtype=np.float64))
    w6 = np.zeros((w3.shape[0], 6))
    w6[:, 2] = w3[:, 0]            # gamma: latency_s
    w6[:, 3] = w3[:, 1]            # theta: dollar
    w6[:, 4] = w3[:, 2]            # zeta: emb_cfp_kg
    w6[:, 5] = w3[:, 2]            # eta:  ope_cfp_kg
    return w6


@dataclasses.dataclass
class ScalarizationSweep:
    """K scalarization directions x N tempering chains, one engine run.

    Each direction is an Eq. 17 weight row (from
    :func:`simplex_directions` over the latency/cost/CFP axes, or
    ``weights`` for custom rows); each runs its own ``n_chains``-wide
    geometric temperature ladder. On a device-capable objective all
    ``K * N`` chains advance together in the torch tempering engine on
    the objective's ``torch_device`` — per-chain weight rows ride through
    the fused evaluate+cost, and the replica-exchange pair mask blocks
    swaps across direction boundaries. Every proposal (plus the seed
    population) feeds the returned ``SearchResult.frontier`` archive.

    ``budget`` caps total evaluations: sweeps are truncated to whole
    multiples of ``K * N``. The host fallback runs one
    :class:`~repro_torch.pathfinding.strategies.ParallelTempering` per
    direction and merges the frontiers.

    ``frontier_size=0`` is rejected: the frontier archive is this
    strategy's output (``best`` is re-derived from it).
    ``checkpoint_dir`` (device engine only) advances the run in
    ``segment``-sweep chunks and snapshots carry + archive at each
    boundary; ``resume`` restores the newest snapshot (a bit-identical
    continuation)."""

    directions: int = 16
    n_chains: int = 4
    sweeps: int = 100
    swap_every: int = 5
    # Eq. 17 costs are O(1) after min/median normalization, so the sweep
    # ladder defaults to an exploitative range (at a fixed hot ladder
    # every chain is a random walk and the directions never bite)
    t_max: float = 5.0
    t_min: float = 0.005
    frontier_size: int = 256
    weights: Optional[np.ndarray] = None   # [K, 6] override
    segment: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = True

    def weight_rows(self) -> np.ndarray:
        if self.weights is not None:
            w = np.atleast_2d(np.asarray(self.weights, dtype=np.float64))
            if w.shape[1] != 6:
                raise ValueError(f"weights must be [K, 6], got {w.shape}")
            return w
        return directions_to_weights(simplex_directions(self.directions))

    def ladder(self) -> np.ndarray:
        """Geometric ``n_chains`` temperature ladder t_max -> t_min."""
        n = self.n_chains
        ratio = (self.t_min / self.t_max) ** (1.0 / max(1, n - 1))
        return np.array([self.t_max * ratio ** i for i in range(n)])

    def chain_temps(self, k: int) -> np.ndarray:
        """``[k * n_chains]`` temperatures: the ladder repeated per
        direction."""
        return np.tile(self.ladder(), k)

    def chain_weights(self, w6: np.ndarray) -> np.ndarray:
        """``[K * n_chains, 6]`` per-chain Eq. 17 rows from ``[K, 6]``
        direction rows."""
        return np.repeat(w6, self.n_chains, axis=0)

    def chain_pair_mask(self, total: int) -> np.ndarray:
        """Replica-exchange gate: pair (j, j+1) may swap only when both
        chains share a direction ladder."""
        if total <= 1:
            return np.ones(1, dtype=bool)
        return (np.arange(total - 1) + 1) % self.n_chains != 0

    def search(self, space: DesignSpace, objective, budget=None, key=None):
        from repro_torch.pathfinding.strategies import (
            ParallelTempering,
            _check_budget,
            _check_checkpointable,
            _resolve_key,
            budget_sweeps,
        )

        _check_budget(budget)
        _check_checkpointable(self.checkpoint_dir, objective)
        key = _resolve_key(key)
        if self.frontier_size < 1:
            raise ValueError(
                "ScalarizationSweep requires frontier_size >= 1: the "
                "frontier archive is the strategy's output (best is "
                f"re-derived from it), got {self.frontier_size}")
        w6 = self.weight_rows()
        k, n = w6.shape[0], self.n_chains
        total = k * n
        sweeps = budget_sweeps(
            self.sweeps, total, budget,
            detail=f" ({k} directions x {n} chains)")

        if objective.device:
            return self._search_device(space, objective, w6, sweeps, key)

        # host fallback: one PT run per direction, frontiers merged
        archive = ParetoArchive(max_size=self.frontier_size)
        evals = 0
        history: List[float] = []
        for i in range(k):
            obj_i = dataclasses.replace(
                objective, template=Template(f"dir{i}", *w6[i]))
            pt = ParallelTempering(
                n_chains=n, t_max=self.t_max, t_min=self.t_min,
                sweeps=sweeps, swap_every=self.swap_every,
                frontier_size=self.frontier_size)
            res = pt.search(space, obj_i, None, key=key * 7919 + i)
            evals += res.evaluations
            history.append(res.best_cost)
            if res.frontier is not None:
                archive.merge(res.frontier)
        return self._finalize(space, objective, archive, history, evals)

    def _search_device(self, space: DesignSpace, objective, w6,
                       sweeps: int, key):
        """All ``K * N`` chains in one engine run. The chains are seeded
        with ``random_system`` alone (no NoC/schedule seeding), as the
        reference's device path seeds them."""
        from repro_torch.pathfinding.strategies import _checkpointer

        k = w6.shape[0]
        total = k * self.n_chains
        rng = random.Random(key)
        chains = [random_system(rng, objective.db, space.max_chiplets)
                  for _ in range(total)]
        archive = ParetoArchive(max_size=self.frontier_size)
        res = objective._device_evaluator(space).parallel_tempering(
            space.encode_many(chains), self.chain_temps(k), sweeps,
            self.swap_every, seed=key, norm=objective.norm,
            template=objective.template, weights=self.chain_weights(w6),
            pair_mask=self.chain_pair_mask(total),
            segment=self.segment, archive=archive,
            checkpoint=_checkpointer(self.checkpoint_dir),
            resume=self.resume)
        return self._finalize(space, objective, archive,
                              res.history, res.evaluations)

    def _finalize(self, space, objective, archive, history, evals):
        """Best-by-template from the archive (one batched re-evaluation of
        <= max_size frontier rows, not counted against the budget)."""
        from repro_torch.pathfinding.strategies import SearchResult

        if len(archive) == 0:
            raise RuntimeError("scalarization sweep produced no samples")
        mb, cost = objective.eval_cost_encoded(archive.encoded, space)
        i = int(np.argmin(cost))
        best = space.decode(archive.encoded[i])
        return SearchResult(best, mb.row(i), float(cost[i]),
                            list(history), evals, objective.cache,
                            frontier=archive)


# ---------------------------------------------------------------------------
# ScenarioSweep: frontier x deployment region x workload
# ---------------------------------------------------------------------------

# representative grid carbon intensities, kg CO2 / kWh (world-average
# default matches techdb.CARBON_INTENSITY_KG_PER_KWH)
REGION_INTENSITIES: Dict[str, float] = {
    "hydro": 0.024,        # e.g. NO/IS grids
    "nuclear-heavy": 0.085,
    "eu-avg": 0.276,
    "world-avg": 0.475,
    "coal-heavy": 0.820,
}


def workloads_from_configs(names: Sequence[str],
                           tokens: int = 512) -> List[GEMMWorkload]:
    """MLP up-projection GEMMs (``tokens x d_model x d_ff``) for model
    configs from :mod:`repro_torch.configs`, the dominant GEMM shape of
    each architecture, usable anywhere a Table IV workload is. Every name
    of ``ARCH_NAMES`` resolves (a moe config's ``d_ff`` is its per-expert
    width)."""
    from repro_torch.configs import get_config

    out = []
    for name in names:
        cfg = get_config(name)
        out.append(GEMMWorkload(f"{cfg.name}-mlp{tokens}", tokens,
                                cfg.d_model, cfg.d_ff))
    return out


def fold_cell_key(base: int, idx: int) -> int:
    """Deterministic per-cell search key: ``fold_in`` of the cell index
    into the key of ``base``, as a 63-bit Python int (a valid seed
    itself). Distinct (workload, region) cells explore with distinct,
    reproducible streams; the stacked engine applies the same fold on
    the device, and the host fallback and the per-cell seed populations
    use this helper.

    The key is built from the low 32 bits of ``base``, as the
    reference's is (it calls ``PRNGKey`` in jax's default 32-bit mode,
    which truncates the seed), while the engine's own key keeps all 64
    bits of the seed (ROADMAP queue 3, R8)."""
    a, b = (int(x) for x in trandom.fold_in(
        trandom.PRNGKey(int(base) & 0xFFFFFFFF), idx).tolist())
    return ((a << 32) | b) & 0x7FFF_FFFF_FFFF_FFFF


def fold_job_key(base: int, job_id: str) -> int:
    """Deterministic per-job search key of the serving layer: the job's
    *name* (not its slot) hashed to a 32-bit index and folded into the
    base key by :func:`fold_cell_key` (so it keeps that function's 32-bit
    base, R8). The key depends only on ``(base, job_id)``, never on the
    slot the scheduler packs the job into or on its co-tenants, which is
    what makes a job's trajectory the same solo or packed."""
    import hashlib

    idx = int.from_bytes(
        hashlib.sha256(str(job_id).encode()).digest()[:4], "big")
    return fold_cell_key(base, idx)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One (workload, deployment region) cell of a sweep.

    ``spec`` carries the full regional axes (price, embodied factor,
    24h profiles); ``carbon_intensity`` stays a plain float for
    reporting (it equals ``spec.carbon_intensity``)."""

    workload: GEMMWorkload
    region: str
    carbon_intensity: float
    spec: Optional[Region] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.workload.name, self.region)


@dataclasses.dataclass
class ScenarioFrontier:
    """Results of a :class:`ScenarioSweep`: one ``SearchResult`` (and
    frontier archive) per scenario."""

    scenarios: List[Scenario]
    results: Dict[Tuple[str, str], "object"]   # key -> SearchResult

    def frontier(self, workload_name: str, region: str) -> ParetoArchive:
        return self.results[(workload_name, region)].frontier

    def merged(self, workload_name: str,
               max_size: int = 512) -> ParetoArchive:
        """Union frontier across regions for one workload (the envelope a
        deployment-portfolio planner optimizes against)."""
        out = ParetoArchive(max_size=max_size)
        for s in self.scenarios:
            if s.workload.name == workload_name:
                out.merge(self.results[s.key].frontier)
        return out

    def rows(self):
        """Flat (workload, region, ci, latency, dollar, cfp) rows for
        CSV/JSON reporting."""
        for s in self.scenarios:
            arch = self.results[s.key].frontier
            for v in arch.vectors:
                yield (s.workload.name, s.region, s.carbon_intensity,
                       float(v[0]), float(v[1]), float(v[2]))


@dataclasses.dataclass
class ScenarioSweep:
    """Map the Pareto frontier across deployment regions and workloads.

    Each (workload, region) cell runs the inner
    :class:`ScalarizationSweep` under the region's axes: scalar grid
    carbon intensity and, through :class:`~repro_torch.core.regions.
    Region` values in ``regions``, a 24h grid-intensity profile, a
    regional electricity price (and price profile) and an embodied
    factor. Every cell gets a distinct key (:func:`fold_cell_key`).

    On the device path the whole grid is **one stacked population** of
    the :class:`~repro_torch.pathfinding.device.ScenarioEngine`: a sweep
    of all S cells is one evaluation, one ``prefix_select`` launch. The
    normalizer fits batch too: one evaluation per workload plus exact
    per-region rescales (:func:`~repro_torch.pathfinding.batch.
    fit_region_normalizers`). The device path seeds each cell with
    ``random_system`` alone, as the reference does.

    ``budget`` is the *total* evaluation budget, split evenly across
    cells (``budget // n_cells`` each). ``shard`` picks the mesh the
    cells are split over (:func:`~repro_torch.distributed.scenario_mesh`):
    ``True`` the ranks of the live process group (without one, the run's
    one device), ``"auto"`` the same when there are two or more ranks
    (else none), as the JAX package does with its devices, ``False``
    none. A split run gives bit for bit what ``False`` gives: each
    rank runs its block of cells, each cell's key folds in its grid
    index, and the per-cell results are gathered on every rank."""

    strategy: ScalarizationSweep = dataclasses.field(
        default_factory=lambda: ScalarizationSweep(directions=8,
                                                   n_chains=4, sweeps=40))
    regions: Dict[str, RegionLike] = dataclasses.field(
        default_factory=lambda: dict(REGION_INTENSITIES))
    norm_samples: int = 400
    norm_seed: int = 1234
    shard: Union[bool, str] = "auto"
    # communication model of the searched DesignSpace (None = the
    # REPRO_COMM_MODEL-resolved default)
    comm: Optional[str] = None
    # schedule model of the searched DesignSpace (None = the
    # REPRO_SCHEDULE-resolved default)
    schedule: Optional[str] = None

    def run(self, workloads, template: Union[str, Template] = "T1",
            db: TechDB = DEFAULT_DB,
            device: bool = True, budget: Optional[int] = None,
            key: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            resume: bool = True,
            segment: Optional[int] = None,
            torch_device: DeviceLike = None) -> ScenarioFrontier:
        """Run the grid of ``workloads`` (a ``GEMMWorkload``, a sequence
        of them, or a :class:`~repro_torch.pathfinding.scenario.
        ScenarioSpec`) x ``self.regions`` on ``torch_device`` (``None``
        = cuda). A spec supplies the workloads, regions, comm/schedule
        models and the budget/segment/checkpoint knobs; passing those
        loose kwargs alongside a spec is an error. ``segment`` cuts the
        stacked loop into host-driven chunks without changing a bit.

        ``checkpoint_dir`` (device path only) makes the grid
        interruptible: the carry (per-cell populations, costs,
        incumbents, key words and sweep counters) and every per-cell
        frontier archive snapshot at each segment boundary, and
        ``resume=True`` restores the newest snapshot, continuing bit for
        bit as the uninterrupted run would."""
        from repro_torch.pathfinding.batch import fit_region_normalizers
        from repro_torch.pathfinding.pathfinder import Pathfinder
        from repro_torch.pathfinding.scenario import ScenarioSpec
        from repro_torch.pathfinding.strategies import (
            _check_budget,
            _checkpointer,
            _resolve_key,
        )

        if isinstance(workloads, ScenarioSpec):
            spec = workloads
            if (budget is not None or checkpoint_dir is not None
                    or segment is not None):
                raise ValueError(
                    "budget/segment/checkpoint_dir ride inside the "
                    "ScenarioSpec; don't also pass them to run()")
            sweep = dataclasses.replace(
                self, regions=spec.region_map(),
                comm=spec.comm if spec.comm is not None else self.comm,
                schedule=(spec.schedule if spec.schedule is not None
                          else self.schedule))
            return sweep.run(
                list(spec.workloads), template=template, db=db,
                device=device, budget=spec.budget, key=key,
                checkpoint_dir=spec.checkpoint_dir, resume=spec.resume,
                segment=spec.segment, torch_device=torch_device)
        _check_budget(budget)
        if checkpoint_dir is not None and not device:
            raise ValueError(
                "checkpoint_dir requires the device path "
                "(ScenarioSweep.run(device=True)); the per-cell host "
                "fallback cannot checkpoint")
        dev = resolve_device(torch_device)
        if isinstance(workloads, GEMMWorkload):
            workloads = [workloads]
        workloads = list(workloads)
        tpl = TEMPLATES[template] if isinstance(template, str) else template
        base = _resolve_key(key)
        # regions accept floats (scalar-CI cells) or Region specs; a
        # float is a neutral-axes Region
        regions = [(name, as_region(spec))
                   for name, spec in self.regions.items()]
        # cell-major grid: workloads outer, regions inner (cell index =
        # wi * len(regions) + ri)
        cells = [(wi, wl, region, reg)
                 for wi, wl in enumerate(workloads)
                 for region, reg in regions]
        cell_budget = None
        if budget is not None:
            cell_budget = budget // len(cells)
            if cell_budget < 1:
                raise ValueError(
                    f"total budget {budget} < one evaluation per cell "
                    f"({len(cells)} cells)")
        # fail fast on inputs the inner ScalarizationSweep would reject
        # per cell anyway, before paying for the normalizer fits
        strat = self.strategy
        if hasattr(strat, "weight_rows"):
            if strat.frontier_size < 1:
                raise ValueError(
                    "ScenarioSweep requires frontier_size >= 1 on its "
                    "inner ScalarizationSweep (the per-cell frontier "
                    "archives are the sweep's output), got "
                    f"{strat.frontier_size}")
            k = strat.weight_rows().shape[0]
            nc = k * strat.n_chains
            if cell_budget is not None and cell_budget < nc:
                raise ValueError(
                    f"per-cell budget {cell_budget} < one chain "
                    f"population {nc} ({k} directions x {strat.n_chains} "
                    f"chains); total budget must be >= "
                    f"{nc * len(cells)}")
        space = DesignSpace(db, comm=self.comm, schedule=self.schedule)
        norm_of: Dict[Tuple[int, str], object] = {}
        for wi, wl in enumerate(workloads):
            fitted = fit_region_normalizers(
                wl, [reg for _, reg in regions], db,
                samples=self.norm_samples, seed=self.norm_seed, space=space,
                torch_device=dev)
            for (region, _), nz in zip(regions, fitted):
                norm_of[(wi, region)] = nz
        if device:
            return self._run_device(cells, workloads, tpl, db, space,
                                    norm_of, cell_budget, base, segment,
                                    dev, _checkpointer(checkpoint_dir),
                                    resume)

        # host fallback: one Pathfinder per cell, distinct folded keys,
        # split budget, pre-fitted region normalizers
        scenarios: List[Scenario] = []
        results: Dict[Tuple[str, str], object] = {}
        for idx, (wi, wl, region, reg) in enumerate(cells):
            db_s = dataclasses.replace(db, **reg.db_overrides())
            pf = Pathfinder(wl, tpl, db=db_s, device=False,
                            norm=norm_of[(wi, region)],
                            space=DesignSpace(db_s, comm=self.comm,
                                              schedule=self.schedule),
                            torch_device=dev)
            res = pf.search(strategy=self.strategy, budget=cell_budget,
                            key=fold_cell_key(base, idx))
            sc = Scenario(wl, region, reg.carbon_intensity, reg)
            scenarios.append(sc)
            results[sc.key] = res
        return ScenarioFrontier(scenarios, results)

    def _mesh(self, dev):
        """The cells' mesh: the ranks of ``dev``'s type for
        ``shard=True``, the same when there are two or more for
        ``"auto"``, none for ``False``."""
        if self.shard is False:
            return None
        from repro_torch.distributed import scenario_mesh

        return scenario_mesh(min_devices=1 if self.shard is True else 2,
                             torch_device=dev)

    def _run_device(self, cells, workloads, tpl, db, space, norm_of,
                    cell_budget, base, segment, dev, checkpoint=None,
                    resume=True) -> ScenarioFrontier:
        from repro_torch.core.evaluate import evaluate
        from repro_torch.core.scalesim import SimCache
        from repro_torch.pathfinding.device import get_scenario_engine
        from repro_torch.pathfinding.strategies import (
            SearchResult,
            budget_sweeps,
        )

        strat = self.strategy
        w6 = strat.weight_rows()
        k = w6.shape[0]
        nc = k * strat.n_chains
        # run() already rejected cell_budget < nc with grid context
        sweeps = budget_sweeps(strat.sweeps, nc, cell_budget)
        S = len(cells)
        # per-chain layouts come from the inner strategy itself, so the
        # stacked grid and the single-cell device path cannot drift
        temps = np.tile(strat.chain_temps(k), (S, 1))
        weights = np.tile(strat.chain_weights(w6)[None], (S, 1, 1))
        pair = np.tile(strat.chain_pair_mask(nc), (S, 1))
        mm = [norm_of[(wi, region)].weights_arrays()
              for (wi, _, region, _) in cells]
        mins = np.stack([a for a, _ in mm])
        medians = np.stack([b for _, b in mm])
        ci = np.array([reg.carbon_intensity for *_, reg in cells],
                      dtype=np.float64)
        price = np.array([reg.electricity_price for *_, reg in cells],
                         dtype=np.float64)
        embf = np.array([reg.emb_factor for *_, reg in cells],
                        dtype=np.float64)
        profile = np.stack([reg.profile_array() for *_, reg in cells])
        pprofile = np.stack([reg.price_array() for *_, reg in cells])
        widx = np.array([wi for wi, *_ in cells], dtype=np.int32)
        v0 = np.stack([
            space.encode_many([
                random_system(random.Random(fold_cell_key(base, idx)),
                              db, space.max_chiplets)
                for _ in range(nc)])
            for idx in range(S)])
        engine = get_scenario_engine(tuple(workloads), db, space=space,
                                     torch_device=dev)
        archives = [ParetoArchive(max_size=strat.frontier_size)
                    for _ in range(S)]
        res = engine.parallel_tempering(
            v0, temps, sweeps, strat.swap_every, seed=base, mins=mins,
            medians=medians, weights=weights, pair_mask=pair, ci=ci,
            widx=widx, price=price, embf=embf, profile=profile,
            pprofile=pprofile, mesh=self._mesh(dev), segment=segment,
            archives=archives, checkpoint=checkpoint, resume=resume)
        # best-by-template per cell: ONE stacked re-evaluation of the
        # (padded) archives, not counted against the budget
        m = max(len(a) for a in archives)
        enc_f = np.stack([
            a.encoded if len(a) == m else np.concatenate(
                [a.encoded, np.repeat(a.encoded[:1], m - len(a), axis=0)])
            for a in archives])
        wt = np.tile(np.asarray(tpl.weights, dtype=np.float64), (S, 1))
        cost_f, _ = engine.evaluate_cost(enc_f, mins, medians, wt, ci,
                                         widx, price=price, embf=embf,
                                         profile=profile,
                                         pprofile=pprofile)
        cache = SimCache()
        evals_cell = nc * (1 + sweeps)
        scenarios: List[Scenario] = []
        results: Dict[Tuple[str, str], object] = {}
        for s, (wi, wl, region, reg) in enumerate(cells):
            arch = archives[s]
            cc = cost_f[s, :len(arch)]
            i = int(np.argmin(cc))
            best = space.decode(arch.encoded[i])
            db_s = dataclasses.replace(db, **reg.db_overrides())
            best_m = evaluate(best, wl, db_s, cache=cache)
            sc = Scenario(wl, region, reg.carbon_intensity, reg)
            scenarios.append(sc)
            results[sc.key] = SearchResult(
                best, best_m, float(cc[i]), res.history[s].tolist(),
                evals_cell, cache, frontier=arch)
        return ScenarioFrontier(scenarios, results)
