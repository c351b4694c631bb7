"""Regional scenario axes: one cell of a scenario grid, beyond scalar CI.

A :class:`Region` bundles the per-region runtime axes of the scenario
engine (Carbon Connect / ECO-CHIP, see ``repro_torch.core.carbon``):

* ``carbon_intensity`` — scalar grid intensity (kgCO2e/kWh), the first regional axis;
* ``grid_profile``     — optional 24h intensity profile; ``None`` = flat at
  ``carbon_intensity`` (bit-identical to the scalar model);
* ``electricity_price``— regional $/kWh, added to the dollar metric as the
  lifetime electricity bill (0.0 = neutral);
* ``emb_factor``       — regional fab-grid embodied-carbon multiplier
  (1.0 = neutral);
* ``price_profile``    — optional 24h $/kWh price curve; ``None`` = flat
  at ``electricity_price`` (bit-identical to the scalar price). Like the
  grid profile it is dotted with the design's decoded load profile, so
  a schedule-axis search can chase cheap hours as well as clean ones.

``ScenarioSweep`` accepts ``{name: Region}`` as well as the historical
``{name: float}`` — :func:`as_region` coerces a bare float to a
neutral-axes region, which reproduces the scalar-CI behavior exactly.
:func:`measured_profile` pulls 24h intensity rows from the checked-in
ElectricityMaps-style dataset (``repro_torch.core.grid_traces``) instead of
the synthetic :func:`diurnal_profile` sinusoid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.techdb import HOURS_PER_DAY


@dataclasses.dataclass(frozen=True)
class Region:
    """Per-region runtime axes of one scenario cell (all but the scalar
    carbon intensity default to their neutral values)."""

    carbon_intensity: float
    electricity_price: float = 0.0
    emb_factor: float = 1.0
    grid_profile: Optional[Tuple[float, ...]] = None
    price_profile: Optional[Tuple[float, ...]] = None

    def __post_init__(self) -> None:
        for field in ("grid_profile", "price_profile"):
            prof = getattr(self, field)
            if prof is not None:
                prof = tuple(float(x) for x in prof)
                if len(prof) != HOURS_PER_DAY:
                    raise ValueError(
                        f"{field} needs {HOURS_PER_DAY} hourly entries, "
                        f"got {len(prof)}")
                object.__setattr__(self, field, prof)

    def profile_array(self) -> np.ndarray:
        """float64[24] grid-intensity row for the device program; a
        ``None`` profile synthesizes the flat row at ``carbon_intensity``
        (whose in-program correction term is exactly +0.0)."""
        if self.grid_profile is None:
            return np.full(HOURS_PER_DAY, np.float64(self.carbon_intensity))
        return np.asarray(self.grid_profile, dtype=np.float64)

    def price_array(self) -> np.ndarray:
        """float64[24] electricity-price row for the device program; a
        ``None`` curve synthesizes the flat row at ``electricity_price``
        (whose in-program correction term is exactly +0.0)."""
        if self.price_profile is None:
            return np.full(HOURS_PER_DAY, np.float64(self.electricity_price))
        return np.asarray(self.price_profile, dtype=np.float64)

    def db_overrides(self) -> dict:
        """Field patch for ``dataclasses.replace(db, **...)`` so the
        scalar path evaluates under this region's axes."""
        return dict(carbon_intensity=self.carbon_intensity,
                    electricity_price=self.electricity_price,
                    emb_factor=self.emb_factor,
                    grid_profile=self.grid_profile,
                    price_profile=self.price_profile)


RegionLike = Union[float, Region]


def as_region(spec: RegionLike) -> Region:
    """Coerce a scenario-cell spec: a bare float is the historical
    scalar-CI region with neutral price/embodied/profile axes."""
    if isinstance(spec, Region):
        return spec
    return Region(carbon_intensity=float(spec))


def diurnal_profile(ci_mean: float, swing: float = 0.3,
                    peak_hour: int = 19) -> Tuple[float, ...]:
    """Synthetic 24h grid-intensity profile: a sinusoid of relative
    amplitude ``swing`` around ``ci_mean`` peaking at ``peak_hour``
    (evening ramp, duck-curve-ish). Mean over the day equals
    ``ci_mean``, so under a flat load profile the effective intensity
    stays close to the scalar model while hourly structure is real."""
    return tuple(
        ci_mean * (1.0 + swing * math.cos(2.0 * math.pi
                                          * (h - peak_hour) / HOURS_PER_DAY))
        for h in range(HOURS_PER_DAY))


def measured_profile(name: str, season: str = "summer",
                     day: str = "weekday") -> Tuple[float, ...]:
    """Measured 24h grid-intensity trace for a reference region
    (ElectricityMaps-style checked-in dataset, see
    :mod:`repro_torch.core.grid_traces`) — the drop-in replacement for the
    synthetic :func:`diurnal_profile` in examples and benchmarks."""
    from repro_torch.core.grid_traces import grid_trace

    return grid_trace(name, season=season, day=day)
