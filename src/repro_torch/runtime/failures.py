"""Fault tolerance: failure injection, restart supervision, stragglers
(the JAX package's ``runtime/failures.py``, which imports no framework).

At thousand-node scale the mean time between node failures drops below
the job length, so the runtime must treat failure as the steady state:

  * ``FailureInjector`` — deterministic pseudo-random fault schedule
    (per-step hazard) used by tests and the example driver to prove the
    restart path end to end.
  * ``RestartSupervisor`` — wraps the step loop; on a (simulated or real)
    fault it restores the newest valid checkpoint and replays from there.
    Because the data pipeline is step-indexed and stateless, replay is
    exact: no data is skipped or repeated relative to a fault-free run.
  * ``StragglerMonitor`` — tracks per-step wall times in a rolling window;
    steps slower than ``threshold`` x median are flagged. The mitigation
    hook reports the straggling host set so the launcher can re-slice the
    batch (elastic rescale) or evict the host; within a step, the batch
    re-slicing path is exercised by shrinking the active host count.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Deque, List, Optional

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised by the injector at scheduled steps."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic hazard: fails at steps where hash(seed, step) < rate."""

    rate: float = 0.0
    seed: int = 0
    max_failures: int = 1_000_000

    def __post_init__(self):
        self._failed = 0
        self._fired = set()

    def check(self, step: int) -> None:
        """Faults are transient: a scheduled fault fires once; the replay
        of the same step after restart succeeds (node replaced)."""
        if self.rate <= 0 or self._failed >= self.max_failures:
            return
        if step in self._fired:
            return
        rng = np.random.default_rng((self.seed << 20) ^ step)
        if rng.random() < self.rate:
            self._failed += 1
            self._fired.add(step)
            raise SimulatedFailure(f"injected fault at step {step}")

    @property
    def failures(self) -> int:
        return self._failed


class StragglerMonitor:
    """Rolling-window straggler detection over per-step durations."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._times: Deque[float] = collections.deque(maxlen=window)
        self.flagged_steps: List[int] = []

    def observe(self, step: int, duration_s: float) -> bool:
        """Record; returns True if this step straggled."""
        is_straggler = False
        if len(self._times) >= max(4, self.window // 4):
            med = statistics.median(self._times)
            if duration_s > self.threshold * med:
                is_straggler = True
                self.flagged_steps.append(step)
        self._times.append(duration_s)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    replayed_steps: int = 0
    completed_steps: int = 0
    straggler_steps: int = 0


class RestartSupervisor:
    """Run ``n_steps`` of ``step_fn(step, state) -> state`` under failure
    injection with checkpoint/restart.

    ``save_fn(step, state)`` checkpoints; ``restore_fn() -> (step, state)``
    returns the newest checkpoint (or (0, initial) if none). The supervisor
    guarantees forward progress: the step after a restore re-executes with
    identical data (step-indexed pipeline), so results match a fault-free
    run exactly.
    """

    def __init__(self, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, save_every: int,
                 injector: Optional[FailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 max_restarts: int = 64):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.save_every = save_every
        self.injector = injector or FailureInjector(0.0)
        self.monitor = monitor or StragglerMonitor()
        self.max_restarts = max_restarts
        self.stats = RestartStats()

    def run(self, n_steps: int, state):
        step = 0
        while step < n_steps:
            try:
                while step < n_steps:
                    self.injector.check(step)
                    t0 = time.monotonic()
                    state = self.step_fn(step, state)
                    dt = time.monotonic() - t0
                    if self.monitor.observe(step, dt):
                        self.stats.straggler_steps += 1
                    self.stats.completed_steps += 1
                    step += 1
                    if step % self.save_every == 0 or step == n_steps:
                        self.save_fn(step, state)
            except SimulatedFailure:
                if self.stats.restarts >= self.max_restarts:
                    raise
                self.stats.restarts += 1
                restored_step, state = self.restore_fn()
                self.stats.replayed_steps += step - restored_step
                step = restored_step
        return state
