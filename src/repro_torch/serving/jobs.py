"""Job model of the pathfinding service (the counterpart of
:mod:`repro.serving.jobs`).

A *job* is one multi-objective search — a
:class:`~repro_torch.pathfinding.pareto.ScalarizationSweep` over one
(workload, deployment region) cell — submitted to the shared warm
engine instead of run as a blocking call. The service packs jobs into
slots of a batched scenario axis and advances everybody one *segment*
(a fixed number of sweeps) at a time, so a job's lifecycle is quantized
at segment boundaries:

    PENDING -> RUNNING -> DONE
                  |  ^
                  v  |  (pause/resume_job, preemption)
               PAUSED -> PENDING
    PENDING/RUNNING -> CANCELLED      (cancel; slot freed at boundary)
    RUNNING -> FAILED                 (admission/engine error)

Determinism contract: a job's RNG stream is derived from
:func:`repro_torch.pathfinding.pareto.fold_job_key` over its *job id* — never
from the slot it lands in — and its sweep counter rides per-slot
through the engine loop, so history/best/frontier are bit-identical
whether the job runs solo, packed next to arbitrary co-tenants, or is
preempted and resumed (including across a restart of the whole
service, via per-job :class:`~repro_torch.pathfinding.resume
.SearchCheckpointer` snapshots at every boundary).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.regions import Region, as_region
from repro_torch.core.techdb import HOURS_PER_DAY
from repro_torch.pathfinding.pareto import ParetoArchive, ScalarizationSweep


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PAUSED = "paused"
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"


#: states a job never leaves
TERMINAL = (JobState.DONE, JobState.CANCELLED, JobState.FAILED)


class JobEvictedError(KeyError):
    """A job finished and its record was garbage-collected past the
    service's ``retain_jobs`` retention cap.

    Subclasses :class:`KeyError` (lookups by id still behave like a
    missing key for callers that catch broadly) but renders its message
    verbatim instead of KeyError's quoted-args repr, so clients see why
    the id is gone and what to do about it."""

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0] if self.args else ""


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What a client submits.

    ``job_id`` is the identity: it names the RNG stream (via
    :func:`~repro_torch.pathfinding.pareto.fold_job_key`), the checkpoint
    subdirectory, and the handle for ``status``/``result``/``cancel``.
    Resubmitting the same spec to a service with a checkpoint root
    resumes the job bit-identically from its newest snapshot.

    ``workload`` must name one of the workloads the service was built
    over (the stacked engine bakes its tile tables per workload set).
    ``strategy`` carries the search knobs; its ``sweeps`` are rounded
    *up* to whole service segments (jobs join and leave the batch only
    at segment boundaries). ``budget`` caps total evaluations with the
    :func:`~repro_torch.pathfinding.strategies.budget_sweeps` total-split
    semantics, applied *before* the round-up."""

    job_id: str
    workload: str
    strategy: ScalarizationSweep = dataclasses.field(
        default_factory=lambda: ScalarizationSweep(
            directions=2, n_chains=2, sweeps=8))
    carbon_intensity: float = 0.475
    # regional lifecycle axes (neutral defaults reproduce the
    # scalar-CI job bit-for-bit): $/kWh electricity price, embodied
    # multiplier, optional 24h grid-intensity profile (None = flat at
    # carbon_intensity). These loose fields are the historical API;
    # ``region`` is the unified one — a single
    # :class:`~repro_torch.core.regions.Region` value carrying all the axes
    # (including the 24h price curve the loose fields never exposed).
    # Setting both at once is an error.
    electricity_price: float = 0.0
    emb_factor: float = 1.0
    grid_profile: Optional[Tuple[float, ...]] = None
    region: Optional[Region] = None
    budget: Optional[int] = None
    key: Optional[int] = None
    # communication model of the searched design space: "legacy" (the
    # bit-pinned default) or "mesh_noc" (adds per-chiplet mesh-dims /
    # NoI-entry axes). Jobs with different comm models never share a
    # bucket — the encoded row width and the fused program differ.
    comm: str = "legacy"
    # schedule model (repro_torch.core.schedule): "fixed" (the bit-pinned
    # default) or "window" (adds the per-design start-hour/duty-shape
    # axes so the search co-optimizes *when* the design runs). Like
    # ``comm`` it is part of the bucket shape — and it enters the
    # checkpoint fingerprint only when non-neutral, so pre-scheduling
    # checkpoints stay byte-identical.
    schedule: str = "fixed"
    # per-job overrides of the service's adaptive-budget knobs (None =
    # service default); only read when the service runs adaptive=True
    stall_segments: Optional[int] = None
    stall_tol: Optional[float] = None

    def __post_init__(self) -> None:
        if self.grid_profile is not None:
            prof = tuple(float(x) for x in self.grid_profile)
            if len(prof) != HOURS_PER_DAY:
                raise ValueError(
                    f"grid_profile needs {HOURS_PER_DAY} hourly entries, "
                    f"got {len(prof)}")
            object.__setattr__(self, "grid_profile", prof)
        if self.region is not None:
            if (self.carbon_intensity != 0.475
                    or self.electricity_price != 0.0
                    or self.emb_factor != 1.0
                    or self.grid_profile is not None):
                raise ValueError(
                    "pass the deployment region either as the unified "
                    "region= value or as the loose carbon_intensity/"
                    "electricity_price/emb_factor/grid_profile fields, "
                    "not both")
            object.__setattr__(self, "region", as_region(self.region))
        elif (self.carbon_intensity != 0.475
                or self.electricity_price != 0.0
                or self.emb_factor != 1.0
                or self.grid_profile is not None):
            import warnings

            warnings.warn(
                "loose JobSpec regional fields (carbon_intensity/"
                "electricity_price/emb_factor/grid_profile) are "
                "deprecated: pass the unified region="
                "repro_torch.core.regions.Region(...) instead (bit-identical, "
                "and it carries the 24h price curve too)",
                DeprecationWarning, stacklevel=3)
        from repro_torch.core.comm import COMM_MODELS

        if self.comm not in COMM_MODELS:
            raise ValueError(
                f"unknown comm model {self.comm!r}; "
                f"options: {sorted(COMM_MODELS)}")
        from repro_torch.core.schedule import SCHEDULE_MODELS

        if self.schedule not in SCHEDULE_MODELS:
            raise ValueError(
                f"unknown schedule model {self.schedule!r}; "
                f"options: {sorted(SCHEDULE_MODELS)}")

    def bucket_key(self) -> tuple:
        """(total chains, swap cadence, comm model[, schedule]): the
        static shape of the batched program this job can share. The
        schedule model joins the tuple only when non-fixed, so legacy
        bucket keys are unchanged."""
        k = self.strategy.weight_rows().shape[0]
        key = (k * self.strategy.n_chains, self.strategy.swap_every,
               self.comm)
        if self.schedule != "fixed":
            key = key + (self.schedule,)
        return key

    def resolved_region(self) -> Region:
        """The job's deployment region: the unified ``region`` value
        when given, else the loose legacy fields assembled into an
        equivalent (bit-identical) :class:`Region`."""
        if self.region is not None:
            return self.region
        return Region(carbon_intensity=float(self.carbon_intensity),
                      electricity_price=float(self.electricity_price),
                      emb_factor=float(self.emb_factor),
                      grid_profile=self.grid_profile)

    def profile_row(self) -> np.ndarray:
        """float64[24] grid-intensity row for this job's slot; a region
        without a profile synthesizes the flat row at its carbon
        intensity (in-program correction exactly +0.0, i.e. the scalar
        model)."""
        return self.resolved_region().profile_array()

    def pprofile_row(self) -> np.ndarray:
        """float64[24] electricity-price row for this job's slot (flat
        at the region's scalar price when it carries no curve)."""
        return self.resolved_region().price_array()


@dataclasses.dataclass(frozen=True)
class JobResult:
    """Terminal output of a DONE job.

    ``history`` is the per-sweep coldest-chain accepted cost (seed
    population first) — the bit-compared trajectory. ``best_cost`` /
    ``best_enc`` are the scalarized incumbent across the job's chains;
    ``frontier`` the job's own :class:`ParetoArchive`. ``sweeps`` is
    what actually ran (>= the nominal request only via adaptive-budget
    donations, < it only via early convergence)."""

    job_id: str
    history: List[float]
    best_cost: float
    best_enc: np.ndarray
    frontier: ParetoArchive
    evaluations: int
    sweeps: int
    converged_early: bool = False


@dataclasses.dataclass
class SearchJob:
    """Internal mutable per-job record (service-lock protected).

    The numpy ``carry`` mirrors one slot of the batched loop carry —
    chain populations/costs, incumbent, raw RNG key words — and is the
    unit that moves between the live batch, PAUSED parking, and
    checkpoint snapshots."""

    spec: JobSpec
    state: JobState = JobState.PENDING
    widx: int = 0
    seed: int = 0                      # fold_job_key(base, job_id)
    # static per-slot rows (built once at first admission)
    temps: Optional[np.ndarray] = None        # [nc]
    weights: Optional[np.ndarray] = None      # [nc, 6]
    pair_mask: Optional[np.ndarray] = None    # [max(nc-1, 1)]
    mins: Optional[np.ndarray] = None         # [6]
    medians: Optional[np.ndarray] = None      # [6]
    # live search state
    carry: Optional[Dict[str, np.ndarray]] = None
    sweep_done: int = 0
    target_sweeps: int = 0             # nominal, rounded up to segments
    extra_sweeps: int = 0              # adaptive-budget extensions
    history: Optional[List[float]] = None
    archive: Optional[ParetoArchive] = None
    # adaptive-budget convergence tracking (host-side, not checkpointed)
    hv_ref: Optional[np.ndarray] = None
    hv_last: float = 0.0
    stall: int = 0
    converged_early: bool = False
    # control flags, applied at the next segment boundary
    want_pause: bool = False
    want_cancel: bool = False
    # terminal-transition order stamp (drives retention-cap GC)
    finished_seq: int = -1
    slot: Optional[int] = None
    fingerprint: Optional[np.ndarray] = None
    checkpointer: Optional[object] = None
    result: Optional[JobResult] = None
    error: Optional[BaseException] = None

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def remaining(self) -> int:
        return max(0, self.target_sweeps + self.extra_sweeps
                   - self.sweep_done)
