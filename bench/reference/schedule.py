"""Carbon-aware temporal scheduling: "when to run" as an encoded axis.

The 24h grid-intensity profile is a runtime column of the fused
program, but the *load* weighting stayed one global, static
``TechDB.load_profile``. This module is the schedule seam — the temporal
twin of ``repro_torch.core.comm``:

* ``fixed``  — the load profile is ``db.load_profile``, a per-db
  constant. The bit-pinned default; every golden was recorded under it.
* ``window`` — each design carries two extra int32 axes: a start-hour
  offset (0..23) and a duty-window *shape* index into the small
  :data:`SCHEDULE_SHAPES` table. The decoded load profile is the shape
  row rolled to the start hour — pure gather arithmetic over trace-time
  constant tables, so schedules are *data*, not shapes, and a whole
  region x workload grid stays ONE fused compile (the ``MESH_DIMS``
  pattern of the comm seam).

Shape rows are 24h duty weights summing to exactly 1: the deployment
model keeps total lifetime work fixed (``duty_runs_per_s`` over the
active fraction), so a schedule only moves *when* the energy is drawn,
never how much. Concentrating the same kWh into low-intensity (or
low-price) hours is therefore the Carbon Connect temporal-shifting
lever, co-designed with architecture/mapping/packaging by the search.

Neutrality. ``SCHED_NEUTRAL == (0, 0)`` is the exact neutral element:
:func:`schedule_tables` *replaces* row 0 with ``db.load_profile``, so
the neutral gather reproduces the per-db load values bit-for-bit and
every windowed term reduces to the legacy arithmetic — which is what
lets the forced-on CI lane (``REPRO_SCHEDULE=window``) replay all
legacy goldens through the windowed program.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .techdb import HOURS_PER_DAY, TechDB, DEFAULT_DB

SCHEDULE_MODELS: Tuple[str, ...] = ("fixed", "window")
DEFAULT_SCHEDULE = "fixed"
# Forces default-constructed DesignSpaces onto the windowed encoding with
# the schedule axes *frozen at neutral* — the CI lane proving the windowed
# program is bit-invisible. Explicit ``DesignSpace(schedule="window")``
# makes the axes live instead.
SCHEDULE_ENV_VAR = "REPRO_SCHEDULE"

# Searchable duty-window shapes. Index 0 is the neutral element — the
# per-db ``load_profile`` itself (see ``schedule_tables``) — so a (0, 0)
# schedule is the bit-exact fixed-schedule limit. Shapes 1+ are
# contiguous always-on windows of W hours (weight 1/W inside, 0 outside,
# anchored at hour 0 before the start-hour roll), summing to exactly 1.
SCHEDULE_WINDOW_HOURS: Tuple[int, ...] = (16, 12, 8, 6, 4)
SCHED_NEUTRAL: Tuple[int, int] = (0, 0)


def resolve_schedule(schedule: Optional[str] = None) -> str:
    """Resolve a schedule-model name; ``None`` consults ``REPRO_SCHEDULE``."""
    if schedule is None:
        schedule = DEFAULT_SCHEDULE
    if schedule not in SCHEDULE_MODELS:
        raise ValueError(
            f"unknown schedule model {schedule!r}; "
            f"expected one of {SCHEDULE_MODELS}")
    return schedule


def n_schedule_shapes() -> int:
    """Number of rows in the shape table (neutral row 0 included)."""
    return 1 + len(SCHEDULE_WINDOW_HOURS)


def window_row(hours: int) -> Tuple[float, ...]:
    """A contiguous ``hours``-long duty window anchored at hour 0."""
    if not 1 <= hours <= HOURS_PER_DAY:
        raise ValueError(f"window of {hours}h outside [1, {HOURS_PER_DAY}]")
    w = 1.0 / hours
    return tuple(w if h < hours else 0.0 for h in range(HOURS_PER_DAY))


_TABLES: Dict[Tuple[float, ...], np.ndarray] = {}


def schedule_tables(db: TechDB = DEFAULT_DB) -> np.ndarray:
    """``loads[Si, 24] float64`` duty-weight lookup table for ``db``.

    Row 0 is **replaced by ``db.load_profile``** — the neutral gather
    must reproduce the per-db fixed load bit-for-bit, not a generic
    flat row. Rows 1+ are the :data:`SCHEDULE_WINDOW_HOURS` windows.
    The vectorized engines gather this by the encoded per-design
    ``(start_hour, shape_idx)`` columns — the axes stay runtime data,
    the table is a trace-time constant shared by every windowed program.
    """
    key = tuple(float(x) for x in db.load_profile)
    tab = _TABLES.get(key)
    if tab is None:
        rows = [key] + [window_row(h) for h in SCHEDULE_WINDOW_HOURS]
        tab = np.array(rows, dtype=np.float64)
        tab.setflags(write=False)
        _TABLES[key] = tab
    return tab


def schedule_load_row(schedule: Tuple[int, int],
                      db: TechDB = DEFAULT_DB) -> Tuple[float, ...]:
    """Scalar decoded load profile: the shape row rolled to the start
    hour, ``load[h] = shapes[shape][(h - start) % 24]``. The neutral
    ``(0, 0)`` schedule returns ``db.load_profile``'s values exactly
    (identity roll of the replaced row 0)."""
    start, shape = schedule
    validate_schedule(schedule)
    tab = schedule_tables(db)
    return tuple(float(tab[shape][(h - start) % HOURS_PER_DAY])
                 for h in range(HOURS_PER_DAY))


def validate_schedule(schedule: Tuple[int, int]) -> None:
    """Raise ``ValueError`` unless ``schedule`` is a well-formed
    ``(start_hour, shape_idx)`` pair."""
    if len(schedule) != 2:
        raise ValueError(
            f"schedule carries {len(schedule)} entries, expected "
            f"(start_hour, shape_idx)")
    start, shape = schedule
    if not 0 <= start < HOURS_PER_DAY:
        raise ValueError(
            f"start hour {start} outside [0, {HOURS_PER_DAY})")
    if not 0 <= shape < n_schedule_shapes():
        raise ValueError(
            f"shape index {shape} outside [0, {n_schedule_shapes()})")
