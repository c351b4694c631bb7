"""Optimization templates (Table V) and the SA cost function (Eq. 17).

SA-Cost = alpha*E + beta*A + gamma*L + theta*M + zeta*C_emb + eta*C_ope,
with each metric min-median normalized over a population of random valid
systems (Sec V-C) so no single term dominates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np

from .evaluate import Metrics

METRIC_FIELDS = ("energy_j", "area_mm2", "latency_s", "dollar",
                 "emb_cfp_kg", "ope_cfp_kg")


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    alpha: float   # energy
    beta: float    # area
    gamma: float   # latency
    theta: float   # dollar cost
    zeta: float    # embodied CFP
    eta: float     # operational CFP

    @property
    def weights(self):
        return (self.alpha, self.beta, self.gamma,
                self.theta, self.zeta, self.eta)

    def without_carbon(self) -> "Template":
        """The *CarbonPATH w/o carbon* ablation: zeta = eta = 0."""
        return Template(self.name + "-noC", self.alpha, self.beta,
                        self.gamma, self.theta, 0.0, 0.0)


TEMPLATES: Mapping[str, Template] = {
    "T1": Template("T1", 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
    "T2": Template("T2", 0.8, 0.2, 0.1, 0.1, 0.2, 0.7),
    "T3": Template("T3", 0.1, 0.1, 0.7, 0.7, 0.1, 0.1),
    "T4": Template("T4", 0.6, 0.6, 0.1, 0.1, 0.6, 0.6),
}


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Min/median normalization fitted on a random-valid-system population
    (the paper uses 10,000 samples): x -> (x - min) / median."""

    mins: Dict[str, float]
    medians: Dict[str, float]

    @classmethod
    def fit(cls, population: Sequence[Metrics]) -> "Normalizer":
        mins: Dict[str, float] = {}
        medians: Dict[str, float] = {}
        for f in METRIC_FIELDS:
            vals = sorted(getattr(m, f) for m in population)
            mins[f] = vals[0]
            medians[f] = _positive_median(vals)
        return cls(mins, medians)

    @classmethod
    def fit_arrays(cls, fields: Mapping[str, "np.ndarray"]) -> "Normalizer":
        """Fit from struct-of-arrays metrics (one array per METRIC_FIELDS
        entry), e.g. a :class:`repro_torch.pathfinding.MetricsBatch`."""
        mins: Dict[str, float] = {}
        medians: Dict[str, float] = {}
        for f in METRIC_FIELDS:
            vals = np.asarray(fields[f], dtype=np.float64)
            mins[f] = float(vals.min())
            medians[f] = _positive_median(sorted(vals.tolist()))
        return cls(mins, medians)

    def normalize(self, m: Metrics) -> Dict[str, float]:
        return {
            f: (getattr(m, f) - self.mins[f]) / self.medians[f]
            for f in METRIC_FIELDS
        }

    def weights_arrays(self):
        """(mins, medians) as float64 vectors in METRIC_FIELDS order, for
        batched cost evaluation."""
        return (np.array([self.mins[f] for f in METRIC_FIELDS]),
                np.array([self.medians[f] for f in METRIC_FIELDS]))


def _positive_median(sorted_vals: Sequence[float]) -> float:
    """True median of a pre-sorted sequence (midpoint average for even
    lengths), floored to 1.0 when non-positive so it can divide."""
    n = len(sorted_vals)
    if n % 2:
        mid = sorted_vals[n // 2]
    else:
        mid = 0.5 * (sorted_vals[n // 2 - 1] + sorted_vals[n // 2])
    return mid if mid > 0 else 1.0


IDENTITY_NORMALIZER = Normalizer(
    {f: 0.0 for f in METRIC_FIELDS}, {f: 1.0 for f in METRIC_FIELDS})


def sa_cost(m: Metrics, t: Template,
            norm: Normalizer = IDENTITY_NORMALIZER) -> float:
    """Eq. 17 on normalized metrics."""
    x = norm.normalize(m)
    w = t.weights
    return (w[0] * x["energy_j"] + w[1] * x["area_mm2"]
            + w[2] * x["latency_s"] + w[3] * x["dollar"]
            + w[4] * x["emb_cfp_kg"] + w[5] * x["ope_cfp_kg"])
