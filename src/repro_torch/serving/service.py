"""Pathfinding as a service: continuous batching on a warm engine.

The counterpart of :mod:`repro.serving.service`. :class:`PathfinderService`
keeps ONE warm :class:`~repro_torch.pathfinding.device.ScenarioEngine` on
its ``torch_device`` and multiplexes many concurrent jobs onto it:

* **Shape buckets.** Jobs whose strategies share a ``(total chains,
  swap_every, comm[, schedule])`` shape share a *bucket*: ``slots``
  lanes of the engine's batched scenario axis, whose slot state (chain
  rows, costs, incumbents, key words, per-slot constants) the host keeps
  in numpy between segments. A bucket is warmed once when it is created,
  by one seed evaluation and one segment on filler data (which also
  builds the tables and the device context); admissions, departures and
  restarts warm nothing (``warmups`` counts them per bucket shape).

* **Segment-quantum scheduling.** Each tick moves a bucket's slot state
  to the device once and advances it one *segment* (``segment`` sweeps)
  through the engine's ``segment_runner``. Jobs join and leave only at
  segment boundaries: admission writes a slot's rows, departure frees
  them, and nothing else in the batch notices. Every slot carries its
  own key words and its own sweep counter (the per-cell ``sweep0``
  vector) and no step mixes lanes, so a job's trajectory is the same
  bits solo or packed, whatever its co-tenants do.

* **Preempt + bit-identical resume.** Each job's slot carry, frontier
  archive and history snapshot through a per-job
  :class:`~repro_torch.pathfinding.resume.SearchCheckpointer` at every
  boundary, under ``checkpoint_root/<job_id>``. ``pause`` /
  ``resume_job`` park and re-admit a live job; a restarted service that
  is given the same specs restores every job from its newest snapshot
  and continues the exact sweep stream. The snapshots are the
  reference's (same fingerprint, same tree), so a job restores across
  the two packages too.

* **Adaptive per-cell budgets.** With ``adaptive=True`` a job whose
  frontier hypervolume stalls for ``stall_segments`` consecutive
  boundaries finishes early and donates its remaining sweeps to the
  bucket's pool, from which jobs still improving at their nominal budget
  draw one segment at a time. Donation only changes *when* a job stops,
  never the stream it consumes. Convergence bookkeeping is host state
  and is not checkpointed.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, random as trandom, resolve_device
from repro_torch.core.regions import Region
from repro_torch.core.sa import random_system
from repro_torch.core.techdb import DEFAULT_DB, HOURS_PER_DAY, TechDB
from repro_torch.core.workload import GEMMWorkload
from repro_torch.pathfinding.pareto import ParetoArchive, fold_job_key
from repro_torch.serving.jobs import (
    TERMINAL,
    JobEvictedError,
    JobResult,
    JobSpec,
    JobState,
    SearchJob,
)


def _np(x: torch.Tensor) -> np.ndarray:
    """A writable host copy (the slot state is written in place at
    boundaries, and a CPU tensor's ``numpy()`` shares its memory)."""
    return x.detach().cpu().numpy().copy()


class _Bucket:
    """One warm shape bucket: ``slots`` lanes of an ``nc``-chain batched
    tempering loop, plus the numpy slot state the host owns between
    segments."""

    def __init__(self, service: "PathfinderService", nc: int,
                 swap_every: int, comm: str = "legacy",
                 schedule: str = "fixed"):
        self.nc, self.swap_every, self.comm = nc, swap_every, comm
        self.schedule = schedule
        self.engine = service._engine_for(comm, schedule)
        self.space = self.engine.space
        S = service.slots
        key_np = service._key_np(0)
        # deterministic filler rows: empty slots hold a valid population
        # so the evaluation never sees degenerate inputs
        fv = self.space.encode_many(
            [random_system(random.Random(0), service.db,
                           self.space.max_chiplets)
             for _ in range(nc)])
        self.filler_v = fv
        self.v = np.repeat(fv[None], S, axis=0).astype(np.int32)
        self.costs = np.zeros((S, nc), np.float64)
        self.best_v = self.v[:, 0].copy()
        self.best_c = np.zeros(S, np.float64)
        self.keys = np.repeat(key_np[None], S, axis=0)
        self.sweep0 = np.zeros(S, np.int64)
        self.temps = np.ones((S, nc), np.float64)
        self.mins = np.ones((S, 6), np.float64)
        self.med = np.ones((S, 6), np.float64)
        self.w = np.full((S, nc, 6), 1.0 / 6.0, np.float64)
        self.pair = np.zeros((S, max(nc - 1, 1)), bool)
        self.ci = np.full(S, 0.475, np.float64)
        # regional axes of each lane: neutral columns (0.0 price, 1.0
        # embodied factor, flat-at-ci profile, flat-at-price price curve)
        # reproduce the scalar-CI search bit for bit
        self.price = np.zeros(S, np.float64)
        self.embf = np.ones(S, np.float64)
        self.profile = np.repeat(self.ci[:, None], HOURS_PER_DAY, axis=1)
        self.pprofile = np.repeat(self.price[:, None], HOURS_PER_DAY,
                                  axis=1)
        self.widx = np.zeros(S, np.int32)
        # per-lane move gates of mesh_noc / window buckets: constant 1.0
        # (every job here asked for the model), so lanes stay independent
        # of co-tenants; other buckets never pass the column
        self.noc_on = np.full(S, 1.0 if comm == "mesh_noc" else 0.0,
                              np.float64)
        self.sched_on = np.full(S, 1.0 if schedule == "window" else 0.0,
                                np.float64)
        self.slot_jobs: List[Optional[SearchJob]] = [None] * S

    def free_slot(self) -> Optional[int]:
        for s, j in enumerate(self.slot_jobs):
            if j is None:
                return s
        return None

    def active_slots(self) -> List[int]:
        return [s for s, j in enumerate(self.slot_jobs) if j is not None]

    def clear_slot(self, s: int) -> None:
        """Back to inert filler (lanes are independent either way; this
        keeps dormant state deterministic)."""
        self.slot_jobs[s] = None
        self.v[s] = self.filler_v
        self.costs[s] = 0.0
        self.best_v[s] = self.filler_v[0]
        self.best_c[s] = 0.0
        self.keys[s] = 0
        self.sweep0[s] = 0
        self.temps[s] = 1.0
        self.mins[s] = 1.0
        self.med[s] = 1.0
        self.w[s] = 1.0 / 6.0
        self.pair[s] = False
        self.ci[s] = 0.475
        self.price[s] = 0.0
        self.embf[s] = 1.0
        self.profile[s] = 0.475
        self.pprofile[s] = 0.0
        self.widx[s] = 0

    def consts(self) -> tuple:
        """The per-slot constants of the engine's seed step, in its
        order: ``(mins, med, w, ci, price, embf, profile, pprofile,
        widx)``."""
        return (self.mins, self.med, self.w, self.ci, self.price,
                self.embf, self.profile, self.pprofile, self.widx)

    def gates(self) -> tuple:
        """The trailing move-gate columns this bucket's engine takes."""
        return ((self.noc_on,) if self.comm == "mesh_noc" else ()) + (
            (self.sched_on,) if self.schedule == "window" else ())


class PathfinderService:
    """Async facade over the warm engine: ``submit`` / ``status`` /
    ``result`` / ``cancel`` / ``pause`` / ``resume_job`` / ``step`` /
    ``drain``.

    The service is built over a fixed workload catalog (the stacked
    engine builds its tables per workload set); jobs name a catalog
    entry. ``slots`` lanes per bucket and ``segment`` sweeps per
    scheduling quantum are service-wide constants and part of every
    job's determinism envelope, so keep them stable across restarts of a
    checkpointed service. Everything runs on ``torch_device`` (``None``
    = cuda, raising without a GPU; the CPU only when asked for).

    ``start()`` spawns the background worker thread (which runs torch on
    the service's device); without it the service runs inline inside
    :meth:`drain` (deterministic single-thread mode). With
    ``checkpoint_root`` every job snapshots at each boundary under
    ``<checkpoint_root>/<job_id>``.

    Terminal-job GC: the newest ``retain_jobs`` terminal jobs are kept
    for result pickup; older ones are evicted in the order they finished,
    and a later access to an evicted id raises
    :class:`~repro_torch.serving.jobs.JobEvictedError` (a ``KeyError``)
    naming the cap. Resubmitting an evicted id starts a fresh job (with
    a checkpoint root, resuming from its newest snapshot on disk)."""

    def __init__(self, workloads: Sequence[GEMMWorkload],
                 db: TechDB = DEFAULT_DB, slots: int = 4,
                 segment: int = 2, norm_samples: int = 120,
                 norm_seed: int = 1234, adaptive: bool = False,
                 stall_segments: int = 2, stall_tol: float = 0.0,
                 checkpoint_root: Optional[str] = None,
                 key: Optional[int] = None, space=None,
                 retain_jobs: int = 256,
                 torch_device: DeviceLike = None):
        from repro_torch.pathfinding.device import get_scenario_engine
        from repro_torch.pathfinding.strategies import _resolve_key

        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if segment < 1:
            raise ValueError(f"segment must be >= 1, got {segment}")
        if retain_jobs < 1:
            raise ValueError(
                f"retain_jobs must be >= 1, got {retain_jobs}")
        self.workloads = tuple(workloads)
        if not self.workloads:
            raise ValueError("PathfinderService needs >= 1 workload")
        self.device = resolve_device(torch_device)
        self.db = db
        self.slots, self.segment = int(slots), int(segment)
        self.norm_samples, self.norm_seed = norm_samples, norm_seed
        self.adaptive = bool(adaptive)
        self.stall_segments = int(stall_segments)
        self.stall_tol = float(stall_tol)
        self.checkpoint_root = checkpoint_root
        self.base_key = _resolve_key(key)
        self.engine = get_scenario_engine(self.workloads, db, space=space,
                                          torch_device=self.device)
        self.space = self.engine.space
        #: per-(comm, schedule) warm engines; buckets resolve theirs
        #: lazily so a service only pays for the models its jobs use
        self._engines = {(self.space.comm, self.space.schedule):
                         self.engine}
        self._widx = {wl.name: i for i, wl in enumerate(self.workloads)}
        self._norms: Dict[Tuple[int, Region, str, str], object] = {}
        self._buckets: Dict[tuple, _Bucket] = {}
        #: warmup passes run, per bucket shape: one each, at creation
        self.warmups: Dict[tuple, int] = {}
        self._pool: Dict[tuple, int] = {}      # donated sweeps per bucket
        self.retain_jobs = int(retain_jobs)
        self._jobs: Dict[str, SearchJob] = {}
        self._evicted: set = set()             # ids GC'd past the cap
        self._finished_seq = 0                 # terminal-order stamp
        self._queue: List[str] = []            # FIFO admission order
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "PathfinderService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API ---------------------------------------------------------

    def submit(self, spec: JobSpec) -> str:
        """Queue a job; returns its ``job_id``. FIFO per bucket: jobs
        contending for the same shape are admitted in submission
        order."""
        if spec.workload not in self._widx:
            raise ValueError(
                f"unknown workload {spec.workload!r}: this service was "
                f"built over {sorted(self._widx)}")
        if spec.strategy.frontier_size < 1:
            raise ValueError("serving requires frontier_size >= 1 (the "
                             "frontier archive is the job's output)")
        with self._cond:
            old = self._jobs.get(spec.job_id)
            if old is not None and old.state not in TERMINAL:
                raise ValueError(f"job {spec.job_id!r} is already "
                                 f"{old.state.value}")
            job = SearchJob(spec=spec, widx=self._widx[spec.workload])
            self._evicted.discard(spec.job_id)
            self._jobs[spec.job_id] = job
            self._queue.append(spec.job_id)
            self._cond.notify_all()
        return spec.job_id

    def status(self, job_id: str) -> JobState:
        with self._cond:
            return self._job(job_id).state

    def result(self, job_id: str,
               timeout: Optional[float] = None) -> JobResult:
        """Block until the job is terminal; DONE returns its
        :class:`JobResult`, CANCELLED/FAILED raise."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            job = self._job(job_id)
            while job.state not in TERMINAL:
                if self._thread is None:
                    raise RuntimeError(
                        f"job {job_id!r} is {job.state.value} and no "
                        "worker is running — call start() or drain()")
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TimeoutError(f"job {job_id!r} still "
                                       f"{job.state.value}")
                self._cond.wait(timeout=wait)
            return self._terminal_result(job)

    def cancel(self, job_id: str) -> None:
        """PENDING jobs leave the queue immediately; RUNNING jobs free
        their slot at the next segment boundary."""
        with self._cond:
            job = self._job(job_id)
            if job.state in TERMINAL:
                return
            if job.state in (JobState.PENDING, JobState.PAUSED):
                if job.job_id in self._queue:
                    self._queue.remove(job.job_id)
                job.state = JobState.CANCELLED
                self._note_terminal(job)
            else:
                job.want_cancel = True
            self._cond.notify_all()

    def pause(self, job_id: str) -> None:
        """Preempt at the next boundary: the slot is freed, the carry
        parked (and checkpointed when enabled) for a bit-identical
        continuation via :meth:`resume_job`."""
        with self._cond:
            job = self._job(job_id)
            if job.state == JobState.RUNNING:
                job.want_pause = True
            elif job.state == JobState.PENDING:
                self._queue.remove(job.job_id)
                job.state = JobState.PAUSED
            self._cond.notify_all()

    def resume_job(self, job_id: str) -> None:
        with self._cond:
            job = self._job(job_id)
            if job.state != JobState.PAUSED:
                raise ValueError(f"job {job_id!r} is {job.state.value}, "
                                 "not paused")
            job.state = JobState.PENDING
            job.want_pause = False
            self._queue.append(job.job_id)
            self._cond.notify_all()

    def step(self) -> bool:
        """One inline scheduling quantum: admit whatever fits, then
        advance every bucket with live jobs by one segment. Returns
        whether anything happened."""
        with self._cond:
            return self._tick()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Run until no job is PENDING or RUNNING (PAUSED jobs are
        parked by user intent and don't block a drain). Inline when no
        worker thread is running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                if not self._work_left():
                    return
                if self._thread is not None:
                    wait = None if deadline is None \
                        else deadline - time.monotonic()
                    if wait is not None and wait <= 0:
                        raise TimeoutError("drain timed out")
                    self._cond.wait(timeout=wait)
                    continue
                progressed = self._tick()
                if not progressed and self._work_left():
                    raise RuntimeError(
                        "service is stuck: jobs pending but no slot "
                        "frees (all lanes held by non-terminal jobs?)")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("drain timed out")

    # -- worker thread ------------------------------------------------------

    def start(self) -> "PathfinderService":
        with self._cond:
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._worker, name="pathfinder-service",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            thread, self._thread = self._thread, None
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=60)

    def _worker(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                try:
                    progressed = self._tick()
                except BaseException:
                    # a failed tick must not silently wedge clients
                    for job in list(self._jobs.values()):
                        if job.state in (JobState.RUNNING,
                                         JobState.PENDING):
                            job.state = JobState.FAILED
                            self._note_terminal(job)
                    self._cond.notify_all()
                    raise
                if not progressed:
                    self._cond.wait(timeout=0.05)

    # -- scheduling core (caller holds self._cond) --------------------------

    def _work_left(self) -> bool:
        return any(j.state in (JobState.PENDING, JobState.RUNNING)
                   for j in self._jobs.values())

    def _tick(self) -> bool:
        """One scheduling quantum: admit what fits, then advance every
        bucket with live jobs by one segment. Returns whether anything
        happened."""
        progressed = self._admit_pending()
        for bkey in list(self._buckets):
            if self._buckets[bkey].active_slots():
                self._run_bucket_segment(bkey)
                progressed = True
        return progressed

    def _admit_pending(self) -> bool:
        admitted = False
        blocked: set = set()
        for job_id in list(self._queue):
            job = self._jobs[job_id]
            bkey = job.spec.bucket_key()
            if bkey in blocked:
                continue              # FIFO within a bucket shape
            bucket = self._bucket(bkey)
            slot = bucket.free_slot()
            if slot is None:
                blocked.add(bkey)
                continue
            self._queue.remove(job_id)
            try:
                self._admit(job, bucket, slot)
            # as the reference does, even an interrupt during admission
            # fails the job and the service goes on (ROADMAP R9)
            except BaseException as e:  # noqa: BLE001 - surfaced via job
                job.state = JobState.FAILED
                job.error = e
                bucket.clear_slot(slot)
                self._note_terminal(job)
            admitted = True
            self._cond.notify_all()
        return admitted

    def _segment(self, b: _Bucket, costs, best_c, keys):
        """One segment of bucket ``b`` from its slot state (with the
        given costs, incumbent costs and key tensor): the engine's
        ``(carry, ys)``."""
        fn = b.engine.segment_runner(self.slots, b.nc, self.segment,
                                     b.swap_every, collect_samples=True)
        return fn(b.v, costs, b.best_v, best_c, keys, b.sweep0, b.temps,
                  b.mins, b.med, b.w, b.pair, b.ci, b.price, b.embf,
                  b.profile, b.pprofile, b.widx, *b.gates())

    def _run_bucket_segment(self, bkey: tuple) -> None:
        b = self._buckets[bkey]
        seg = self.segment
        carry, ys = self._segment(
            b, b.costs, b.best_c, trandom.key_from_np(b.keys, self.device))
        b.v = _np(carry[0].to(torch.int32))
        b.costs = _np(carry[1])
        b.best_v = _np(carry[2].to(torch.int32))
        b.best_c = _np(carry[3])
        b.keys = trandom.key_to_np(carry[4])
        hist = ys[0].cpu().numpy()                    # [seg, S]
        enc = ys[2].to(torch.int32).cpu().numpy()     # [seg, S, nc, W]
        vec = ys[3].cpu().numpy()                     # [seg, S, nc, 3]
        b.sweep0 = b.sweep0 + seg
        for s in b.active_slots():
            job = b.slot_jobs[s]
            job.sweep_done += seg
            job.history.extend(hist[:, s].tolist())
            job.archive.insert(enc[:, s].reshape(-1, enc.shape[-1]),
                               vec[:, s].reshape(-1, vec.shape[-1]))
            self._boundary(job, b, s)
        self._cond.notify_all()

    def _boundary(self, job: SearchJob, b: _Bucket, s: int) -> None:
        """Everything that may only happen between segments: snapshot,
        cancellation/preemption, convergence + donation, completion."""
        self._park_carry(job, b, s)
        if job.checkpointer is not None:
            job.checkpointer.save(
                job.sweep_done, job.carry, job.archive,
                np.asarray(job.history, np.float64), job.fingerprint)
        if job.want_cancel:
            job.state = JobState.CANCELLED
            b.clear_slot(s)
            self._note_terminal(job)
            return
        if job.want_pause:
            job.want_pause = False
            job.state = JobState.PAUSED
            b.clear_slot(s)
            return
        bkey = job.spec.bucket_key()
        if self.adaptive:
            self._update_convergence(job)
            if job.converged_early and job.remaining > 0:
                self._pool[bkey] = (self._pool.get(bkey, 0)
                                    + job.remaining)
                self._finalize(job, b, s)
                return
        if job.remaining <= 0:
            if (self.adaptive and not job.converged_early
                    and self._pool.get(bkey, 0) >= self.segment):
                # still improving at its nominal budget: draw a donated
                # segment and keep going
                self._pool[bkey] -= self.segment
                job.extra_sweeps += self.segment
                return
            self._finalize(job, b, s)

    def _update_convergence(self, job: SearchJob) -> None:
        """Frontier-hypervolume stall detector. The reference point is
        frozen at the job's first boundary so successive hypervolumes
        are comparable; ``stall_tol`` is the relative improvement below
        which a boundary counts as stalled."""
        from repro_torch.pathfinding.pareto import hypervolume

        spec = job.spec
        tol = self.stall_tol if spec.stall_tol is None else spec.stall_tol
        k = self.stall_segments if spec.stall_segments is None \
            else spec.stall_segments
        if job.hv_ref is None:
            job.hv_ref = job.archive.reference_point(margin=0.1)
            job.hv_last = hypervolume(job.archive.vectors, job.hv_ref)
            return
        hv = hypervolume(job.archive.vectors, job.hv_ref)
        gain = hv - job.hv_last
        if gain <= tol * max(abs(job.hv_last), 1e-12):
            job.stall += 1
        else:
            job.stall = 0
        job.hv_last = hv
        if job.stall >= k:
            job.converged_early = True

    def _finalize(self, job: SearchJob, b: _Bucket, s: int) -> None:
        job.result = JobResult(
            job_id=job.job_id,
            history=list(job.history),
            best_cost=float(job.carry["best_c"]),
            best_enc=np.asarray(job.carry["best_v"]).copy(),
            frontier=job.archive,
            evaluations=b.nc * (1 + job.sweep_done),
            sweeps=job.sweep_done,
            converged_early=job.converged_early)
        job.state = JobState.DONE
        b.clear_slot(s)
        self._note_terminal(job)

    # -- admission ----------------------------------------------------------

    def _admit(self, job: SearchJob, b: _Bucket, slot: int) -> None:
        from repro_torch.pathfinding.resume import (
            check_not_shrunk,
            segment_fingerprint,
        )
        from repro_torch.pathfinding.strategies import (
            _checkpointer,
            _resolve_key,
            budget_sweeps,
        )

        spec, strat = job.spec, job.spec.strategy
        nc, seg = b.nc, self.segment
        region = spec.resolved_region()
        if job.temps is None:
            w6 = strat.weight_rows()
            k = w6.shape[0]
            job.seed = fold_job_key(
                _resolve_key(spec.key) if spec.key is not None
                else self.base_key, spec.job_id)
            job.temps = strat.chain_temps(k)
            job.weights = strat.chain_weights(w6)
            job.pair_mask = strat.chain_pair_mask(nc)
            job.mins, job.medians = self._norm_rows(job.widx, region,
                                                    b.space)
            sweeps = budget_sweeps(
                strat.sweeps, nc, spec.budget,
                detail=f" for job {spec.job_id!r}")
            # jobs advance in whole segment quanta: round UP so the
            # nominal budget is never silently under-run
            job.target_sweeps = -(-sweeps // seg) * seg if sweeps else 0
        v0 = b.space.encode_many(
            [random_system(random.Random(job.seed), self.db,
                           b.space.max_chiplets)
             for _ in range(nc)]).astype(np.int32)
        if self.checkpoint_root is not None and job.fingerprint is None:
            fp_extra = {}
            if b.comm != "legacy":
                # only a non-legacy comm model enters the envelope, so
                # legacy fingerprints keep the pre-NoC field set
                fp_extra["comm"] = np.frombuffer(b.comm.encode(), np.uint8)
            if b.schedule != "fixed":
                fp_extra["schedule"] = np.frombuffer(
                    b.schedule.encode(), np.uint8)
            if region.price_profile is not None:
                fp_extra["pprofile"] = spec.pprofile_row()
            job.fingerprint = segment_fingerprint(
                "serve_job", v0=v0, temps=job.temps,
                swap_every=b.swap_every, seed=job.seed, mins=job.mins,
                medians=job.medians, weights=job.weights,
                pair_mask=job.pair_mask,
                ci=np.float64(region.carbon_intensity),
                segment=seg, collect=True,
                workload=np.frombuffer(spec.workload.encode(), np.uint8),
                job=np.frombuffer(spec.job_id.encode(), np.uint8),
                price=np.float64(region.electricity_price),
                embf=np.float64(region.emb_factor),
                profile=spec.profile_row(), **fp_extra)
            job.checkpointer = _checkpointer(
                os.path.join(self.checkpoint_root, spec.job_id))
        # slot statics (identical for fresh admission and re-admission)
        b.temps[slot] = job.temps
        b.mins[slot] = job.mins
        b.med[slot] = job.medians
        b.w[slot] = job.weights
        b.pair[slot] = job.pair_mask
        b.ci[slot] = float(region.carbon_intensity)
        b.price[slot] = float(region.electricity_price)
        b.embf[slot] = float(region.emb_factor)
        b.profile[slot] = spec.profile_row()
        b.pprofile[slot] = spec.pprofile_row()
        b.widx[slot] = job.widx

        if job.carry is None and job.checkpointer is not None:
            restored = job.checkpointer.restore(
                dict(v=np.zeros((nc, b.space.width), np.int32),
                     costs=np.zeros(nc, np.float64),
                     best_v=np.zeros(b.space.width, np.int32),
                     best_c=np.zeros((), np.float64),
                     key=np.zeros(2, np.uint32)),
                job.archive or self._fresh_archive(job), job.fingerprint)
            if restored is not None:
                job.carry = dict(restored.carry)
                job.sweep_done = int(restored.sweep_done)
                job.history = restored.history.tolist()
                # adaptive extensions aren't re-donated across restarts
                job.target_sweeps = max(job.target_sweeps,
                                        job.sweep_done)
                check_not_shrunk(job.sweep_done,
                                 job.target_sweeps + job.extra_sweeps)
        if job.carry is None:
            # fresh job: seed-evaluate its slot through the bucket's seed
            # step (its per-slot keys are slot-position dependent and
            # discarded: the job's stream comes from its job id, so
            # packing cannot change it)
            job.archive = job.archive or self._fresh_archive(job)
            b.v[slot] = v0
            _, cost0, vec0 = b.engine.init_step(
                b.v, *b.consts(), trandom.PRNGKey(0, self.device))
            cost_row = _np(cost0[slot])
            vec_row = _np(vec0[slot])
            bi = int(np.argmin(cost_row))
            job.carry = dict(v=v0, costs=cost_row,
                             best_v=v0[bi].copy(),
                             best_c=np.float64(cost_row[bi]),
                             key=self._key_np(job.seed))
            job.history = [float(cost_row.min())]
            job.archive.insert(v0, vec_row)
            if job.checkpointer is not None:
                job.checkpointer.save(
                    0, job.carry, job.archive,
                    np.asarray(job.history, np.float64), job.fingerprint)
        if job.archive is None:
            job.archive = self._fresh_archive(job)
        if job.remaining <= 0:
            # zero-sweep budget or restored-already-complete
            job.slot = None
            self._finalize(job, b, slot)
            return
        job.slot = slot
        b.slot_jobs[slot] = job
        b.v[slot] = job.carry["v"]
        b.costs[slot] = job.carry["costs"]
        b.best_v[slot] = job.carry["best_v"]
        b.best_c[slot] = job.carry["best_c"]
        b.keys[slot] = job.carry["key"]
        b.sweep0[slot] = job.sweep_done
        job.state = JobState.RUNNING

    def _park_carry(self, job: SearchJob, b: _Bucket, s: int) -> None:
        job.carry = dict(v=b.v[s].copy(), costs=b.costs[s].copy(),
                         best_v=b.best_v[s].copy(),
                         best_c=np.float64(b.best_c[s]),
                         key=b.keys[s].copy())

    def _fresh_archive(self, job: SearchJob) -> ParetoArchive:
        job.archive = ParetoArchive(
            max_size=job.spec.strategy.frontier_size)
        return job.archive

    # -- shared warm resources ----------------------------------------------

    def _engine_for(self, comm: str, schedule: str = "fixed"):
        """Warm :class:`ScenarioEngine` for a bucket's (comm, schedule)
        models. The default-space engine built in ``__init__`` serves
        its own pair; any other combination gets an engine over a
        same-bound :class:`DesignSpace` (shared process-wide by
        :func:`get_scenario_engine`'s cache)."""
        eng = self._engines.get((comm, schedule))
        if eng is None:
            from repro_torch.pathfinding.device import get_scenario_engine
            from repro_torch.pathfinding.space import DesignSpace

            sp = DesignSpace(self.db,
                             max_chiplets=self.space.max_chiplets,
                             comm=comm, schedule=schedule)
            eng = get_scenario_engine(self.workloads, self.db, space=sp,
                                      torch_device=self.device)
            self._engines[(comm, schedule)] = eng
        return eng

    def _bucket(self, bkey: tuple) -> _Bucket:
        b = self._buckets.get(bkey)
        if b is None:
            b = _Bucket(self, *bkey)
            self._warmup(b, bkey)
            self._buckets[bkey] = b
        return b

    def _warmup(self, b: _Bucket, bkey: tuple) -> None:
        """Run the bucket's seed step and one segment once, on filler
        data (outputs discarded, slot state untouched): the first use of
        the bucket's shapes, its tables and the device context happens
        here rather than inside a job's first tick."""
        keys0, cost0, _ = b.engine.init_step(
            b.v, *b.consts(), trandom.PRNGKey(0, self.device))
        carry, _ = self._segment(b, cost0, cost0[:, 0], keys0)
        carry[0].cpu()                # wait for the device
        self.warmups[bkey] = self.warmups.get(bkey, 0) + 1

    def _norm_rows(self, widx: int, region: Region,
                   space=None) -> Tuple[np.ndarray, np.ndarray]:
        # Region is frozen/hashable, so the cache key tells apart jobs
        # that share a scalar CI but differ in price/embodied/profile;
        # the comm and schedule models join it, since their normalizers
        # see other cost terms
        space = self.space if space is None else space
        nz = self._norms.get((widx, region, space.comm, space.schedule))
        if nz is None:
            from repro_torch.pathfinding.batch import fit_region_normalizers

            nz = fit_region_normalizers(
                self.workloads[widx], [region], self.db,
                samples=self.norm_samples, seed=self.norm_seed,
                space=space, torch_device=self.device)[0]
            self._norms[(widx, region, space.comm, space.schedule)] = nz
        mins, medians = nz.weights_arrays()
        return (np.asarray(mins, np.float64),
                np.asarray(medians, np.float64))

    @staticmethod
    def _key_np(seed: int) -> np.ndarray:
        return trandom.key_to_np(trandom.PRNGKey(seed))

    # -- internals ----------------------------------------------------------

    def _job(self, job_id: str) -> SearchJob:
        job = self._jobs.get(job_id)
        if job is None:
            if job_id in self._evicted:
                raise JobEvictedError(
                    f"job {job_id!r} finished and was evicted by "
                    f"terminal-job GC (retain_jobs="
                    f"{self.retain_jobs}); fetch results before more "
                    "than retain_jobs jobs finish, raise the cap, or "
                    "resubmit (a checkpoint root resumes it from its "
                    "newest on-disk snapshot)")
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def _note_terminal(self, job: SearchJob) -> None:
        """Stamp the terminal transition order and evict the oldest
        terminal records past ``retain_jobs`` (caller holds
        ``self._cond``). Only terminal jobs are ever evicted."""
        job.finished_seq = self._finished_seq
        self._finished_seq += 1
        term = [j for j in self._jobs.values() if j.state in TERMINAL]
        excess = len(term) - self.retain_jobs
        if excess <= 0:
            return
        term.sort(key=lambda j: j.finished_seq)
        for j in term[:excess]:
            del self._jobs[j.job_id]
            self._evicted.add(j.job_id)

    @staticmethod
    def _terminal_result(job: SearchJob) -> JobResult:
        if job.state == JobState.DONE:
            return job.result
        if job.state == JobState.FAILED and job.error is not None:
            raise RuntimeError(
                f"job {job.job_id!r} failed") from job.error
        raise RuntimeError(f"job {job.job_id!r} is {job.state.value}")

    def donated_pool(self, bucket_key: tuple) -> int:
        """Donated-but-undrawn sweeps for a bucket (observability)."""
        with self._cond:
            return self._pool.get(bucket_key, 0)
