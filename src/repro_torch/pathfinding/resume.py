"""Checkpoint/resume of segmented device searches.

The counterpart of :mod:`repro.pathfinding.resume`. The device engines
(:class:`repro_torch.pathfinding.device.DeviceEvaluator` and
:class:`~repro_torch.pathfinding.device.ScenarioEngine`) advance their
sweeps in *segments* driven by a host loop, and at every segment
boundary the whole search state (chain populations, costs, incumbent
best, RNG key words, per-cell sweep counters, the
:class:`~repro_torch.pathfinding.pareto.ParetoArchive` contents and the
accepted-cost history) can be snapshotted through
:class:`repro_torch.checkpoint.CheckpointManager`. A resumed run consumes
the same key stream as the uninterrupted one, so it reproduces it bit
for bit on the same device.

The snapshot is the reference's tree: the same leaf names, dtypes
(``int32`` rows, ``float64`` costs, ``uint32`` key words) and
fingerprint bytes, so a snapshot written by either package restores in
the other.

* :func:`search_fingerprint` / :func:`segment_fingerprint`: a digest of
  everything that defines the search, stored in every snapshot;
  restoring under another configuration raises instead of continuing a
  different search.
* :class:`SearchCheckpointer`: ``save`` at boundaries, ``restore`` on
  entry (``None`` when no snapshot exists; archives reload in place).
* :func:`run_segmented`: the restore-or-init / advance-in-chunks /
  snapshot-at-boundaries host loop both engines share.

The user surface is ``checkpoint_dir=`` / ``resume=`` on
:class:`~repro_torch.pathfinding.strategies.ParallelTempering`,
:class:`~repro_torch.pathfinding.pareto.ScalarizationSweep`,
:meth:`~repro_torch.pathfinding.pareto.ScenarioSweep.run` and
:meth:`~repro_torch.pathfinding.pathfinder.Pathfinder.run_scenarios`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.checkpoint import ELASTIC, CheckpointManager

# bump when the checkpoint tree layout changes incompatibly: the version
# participates in the fingerprint, so old trees are rejected, not
# misread
STATE_VERSION = 1


def search_fingerprint(kind: str, **parts: Any) -> np.ndarray:
    """``uint64[1]`` digest of a search configuration.

    ``parts`` values are arrays/scalars/None; the digest covers dtype,
    shape and exact bytes, so any change to the seed population, ladder,
    weight rows, normalizer rows, RNG seed or segmentation produces a
    different fingerprint. The total sweep count is deliberately *not*
    part of it: resuming may extend a finished run's budget."""
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(str(STATE_VERSION).encode())
    for name in sorted(parts):
        v = parts[name]
        h.update(name.encode())
        if v is None:
            h.update(b"\x00none")
            continue
        a = np.asarray(v)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.uint64).copy()


def segment_fingerprint(kind: str, *, v0, temps, swap_every, seed, mins,
                        medians, weights, pair_mask, ci,
                        segment: Optional[int], collect: bool,
                        **extra: Any) -> np.ndarray:
    """:func:`search_fingerprint` over the fields every segmented
    tempering engine shares (seed population, ladder, weight rows,
    normalizer rows, exchange gates, carbon intensity, segmentation).

    The *user-facing* ``segment`` knob is hashed (-1 = None), not the
    derived chunk size, so a finished ``segment=None`` run can be resumed
    with a larger sweep budget — the documented extension use case.
    Engine-specific fields (e.g. the scenario grid's workload ids) ride
    in ``extra``.

    The regional lifecycle axes — per-cell ``price``, ``embf`` and the
    24h grid-intensity ``profile`` — DO enter the fingerprint (via
    ``extra``, from every engine): they are search *inputs* that change
    the cost surface, so a checkpoint written under one regional grid
    must not resume under another. Neutral columns are materialized
    before hashing (0.0 / 1.0 / flat-at-ci), which means checkpoints
    written before the axes existed do not fingerprint-match and are
    ignored rather than mis-resumed.

    The schedule policy is the one exception to that materialize-first
    rule: the ``schedule`` model name (and the 24h ``pprofile`` price
    curve on the serving path) enters the fingerprint **only when
    non-neutral** — a ``"window"`` bucket hashes its schedule bytes, a
    ``"fixed"`` one hashes exactly the pre-scheduling field set. The
    neutral ``(0, 0)`` schedule is bit-invisible to the search, so a
    pre-scheduling checkpoint must stay byte-identical and keep
    resuming; a windowed search, whose encoded rows are wider and whose
    cost surface moves with the duty table, must never resume from a
    fixed-schedule snapshot (and vice versa).

    The device is deliberately *outside* the fingerprint: the
    ``prefix_select`` kernel on cuda and its plain version on the CPU
    are exact on the integer prefix tables, so a snapshot written on one
    device (or by the reference package) resumes on another; only float
    noise (~1e-16), never the key stream or sweep indices, can differ
    across the switch."""
    return search_fingerprint(
        kind, v0=v0, temps=temps, swap_every=np.int64(swap_every),
        seed=np.int64(seed), mins=mins, medians=medians, weights=weights,
        pair_mask=pair_mask, ci=ci,
        segment=np.int64(-1 if segment is None else segment),
        collect=np.int64(bool(collect)), **extra)


def check_not_shrunk(done: int, sweeps: int) -> None:
    """Shared resume guard of both segmented engines: a checkpoint
    further along than the requested sweep count must raise, not
    silently hand back the over-run state."""
    if done > sweeps:
        raise ValueError(
            f"checkpoint is {done} sweeps in but this run asks for only "
            f"{sweeps}: shrinking a resumed search would silently "
            "over-run its budget — raise sweeps/budget or start a fresh "
            "checkpoint_dir")


@dataclasses.dataclass
class RestoredSearch:
    """What :meth:`SearchCheckpointer.restore` hands back to the engine."""

    sweep_done: int                     # completed sweeps (min over cells)
    sweep_done_per_cell: np.ndarray     # int64, 0-d (PT) or [S] (scenario)
    carry: Dict[str, np.ndarray]        # the loop carry at the boundary
    history: np.ndarray                 # accepted-cost history so far


class SearchCheckpointer:
    """Segment-boundary snapshot/restore for the device search engines.

    State is tiny (a few KB of chain rows + archive contents), so shards
    default to 1 file per leaf; ``keep`` rotates old boundaries away.
    Pass one instance per search — the directory is the unit of
    resumption."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 1):
        self.directory = directory
        self.manager = CheckpointManager(directory, keep=keep,
                                         n_shards=n_shards)

    # -- engine-facing API --------------------------------------------------

    def save(self, sweep_done: Union[int, np.ndarray],
             carry: Dict[str, np.ndarray],
             archives: Union[None, object, Sequence[object]],
             history: np.ndarray, fingerprint: np.ndarray) -> str:
        """Snapshot one segment boundary (atomic; step = sweeps done)."""
        done = np.asarray(sweep_done, dtype=np.int64)
        tree = {
            "carry": {k: np.asarray(v) for k, v in carry.items()},
            "archives": self._archive_list(archives),
            "history": np.asarray(history, dtype=np.float64),
            "sweep_done": done,
            "fingerprint": np.asarray(fingerprint, dtype=np.uint64),
        }
        return self.manager.save(int(done.min()), tree)

    def restore(self, carry_like: Dict[str, np.ndarray],
                archives: Union[None, object, Sequence[object]],
                fingerprint: np.ndarray) -> Optional[RestoredSearch]:
        """Restore the newest boundary *of this search*, or ``None``
        when the directory holds no checkpoint yet. Archives are
        reloaded in place.

        Snapshots written by a different configuration are skipped (and
        left on disk — they belong to another search, e.g. survivors of
        a ``resume=False`` restart sharing the directory); corrupt ones
        are pruned like :meth:`CheckpointManager.restore` does. Only
        when the directory holds snapshots but *none* match does this
        raise ``ValueError`` — the config changed under an existing
        checkpoint_dir."""
        import shutil

        from repro_torch.checkpoint import (
            CorruptCheckpointError,
            load_checkpoint,
        )

        arch_list = self._archive_list(archives)
        like = {
            "carry": {k: np.asarray(v) for k, v in carry_like.items()},
            "archives": arch_list,
            "history": ELASTIC,
            "sweep_done": ELASTIC,
            "fingerprint": np.zeros(1, dtype=np.uint64),
        }
        want = np.asarray(fingerprint, dtype=np.uint64)
        tree = None
        mismatched = 0
        for s in reversed(self.manager.all_steps()):
            path = self.manager.step_path(s)
            try:
                _, t = load_checkpoint(path, like)
            except CorruptCheckpointError:
                shutil.rmtree(path, ignore_errors=True)
                continue
            except (KeyError, ValueError):
                # structurally incompatible = written by a different
                # search shape (e.g. another chain count): foreign, not
                # corrupt — skip it, keep looking for our own snapshot
                mismatched += 1
                continue
            if not np.array_equal(
                    np.asarray(t["fingerprint"], dtype=np.uint64), want):
                mismatched += 1
                continue
            tree = t
            break
        if tree is None:
            if mismatched:
                raise ValueError(
                    f"checkpoint in {self.directory} was written by a "
                    "different search configuration (seed / ladder / "
                    "weights / normalizer / segment size changed) — "
                    "point checkpoint_dir at a fresh directory or pass "
                    "resume=False")
            return None
        for dst, src in zip(arch_list, tree["archives"]):
            dst.load_checkpoint_arrays(src.checkpoint_arrays())
        done = np.asarray(tree["sweep_done"], dtype=np.int64)
        return RestoredSearch(
            sweep_done=int(done.min()),
            sweep_done_per_cell=done,
            carry={k: np.asarray(v) for k, v in tree["carry"].items()},
            history=np.asarray(tree["history"], dtype=np.float64))

    @staticmethod
    def _archive_list(archives) -> List[object]:
        if archives is None:
            return []
        if isinstance(archives, (list, tuple)):
            return list(archives)
        return [archives]


class RankZeroCheckpoint:
    """A checkpoint that the ranks of a split scenario grid share: each
    rank restores from it, only rank 0 writes (every rank holds the same
    gathered state), and the others wait until the write is done. When
    rank 0's save raises, every rank raises (rank 0 its own error), so
    no rank is left waiting in a collective."""

    def __init__(self, inner, mesh):
        self.inner = inner
        self.mesh = mesh

    def restore(self, *args, **kwargs):
        return self.inner.restore(*args, **kwargs)

    def save(self, *args, **kwargs):
        import torch
        import torch.distributed as dist

        rank = self.mesh.get_local_rank()
        err, path = None, None
        if rank == 0:
            try:
                path = self.inner.save(*args, **kwargs)
            except BaseException as e:   # noqa: BLE001 — re-raised below
                err = e
        failed = torch.tensor([err is not None], dtype=torch.int32,
                              device=self.mesh.device_type)
        dist.all_reduce(failed, group=self.mesh.get_group())
        if err is not None:
            raise err
        if int(failed.item()):
            raise RuntimeError("rank 0 failed to save the checkpoint")
        return path


def run_segmented(*, sweeps: int, seg_size: int, checkpoint, resume: bool,
                  fingerprint: Optional[np.ndarray],
                  archives: Union[None, object, Sequence[object]],
                  carry_like: Optional[Dict[str, np.ndarray]],
                  fresh: Callable[[], Any],
                  from_restored: Callable[[RestoredSearch], Any],
                  run_segment: Callable[[Any, int, int], Tuple[Any, Any]],
                  absorb: Callable[[Any, int], None],
                  carry_np: Callable[[Any], Dict[str, np.ndarray]],
                  history_np: Callable[[], np.ndarray],
                  sweep_counter: Callable[[int], Union[int, np.ndarray]],
                  flush_seed: Callable[[], None]) -> Tuple[Any, int]:
    """The host segment loop shared by both device tempering engines
    (restore-or-init / advance-in-chunks / snapshot-at-boundaries).

    :meth:`DeviceEvaluator.parallel_tempering
    <repro_torch.pathfinding.device.DeviceEvaluator.parallel_tempering>` and
    :meth:`ScenarioEngine.parallel_tempering
    <repro_torch.pathfinding.device.ScenarioEngine.parallel_tempering>` differ
    only in what the carry *is* (single-cell vs stacked, one RNG key vs a
    per-cell key matrix), how a segment's outputs are absorbed (flat
    history + one archive vs per-cell histories + per-cell archives) and
    what the checkpoint's sweep counter looks like (scalar vs per-cell
    vector); the control flow — which is what checkpoint correctness
    hangs on — is this one function:

    1. With ``checkpoint``/``resume``, restore the newest matching
       snapshot; otherwise initialize fresh state via ``fresh()``
       (``from_restored(r)`` rebuilds the device carry; a restored run
       further along than ``sweeps`` raises via
       :func:`check_not_shrunk`).
    2. Advance in chunks: ``run_segment(carry, done, seg)`` invokes the
       engine's segment step for ``seg = min(seg_size, sweeps - done)``
       sweeps; ``absorb(ys, seg)`` feeds history/archives (including the
       engine's lazily-prepended seed block).
    3. After every chunk, snapshot ``(sweep_counter(done),
       carry_np(carry), archives, history_np(), fingerprint)``.
    4. ``flush_seed()`` covers the zero-sweep / resumed-complete edge
       where the loop body never ran to consume the seed block.

    Returns ``(carry, done)``. Without a checkpoint this drives the same
    call sequence as a plain segment loop, so the trajectory (and the
    ``device_pt_wl1_t1`` golden) is unchanged."""
    restored = None
    if checkpoint is not None and resume:
        restored = checkpoint.restore(carry_like, archives, fingerprint)
    if restored is None:
        carry = fresh()
        done = 0
    else:
        carry = from_restored(restored)
        done = restored.sweep_done
        check_not_shrunk(done, sweeps)
    while done < sweeps:
        seg = min(seg_size, sweeps - done)
        carry, ys = run_segment(carry, done, seg)
        absorb(ys, seg)
        done += seg
        if checkpoint is not None:
            checkpoint.save(sweep_counter(done), carry_np(carry),
                            archives, history_np(), fingerprint)
    # a zero-sweep run (or a resumed-complete one) never feeds the seed
    # population through the loop
    flush_seed()
    return carry, done
