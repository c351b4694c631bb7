"""The plain reference of the benchmark: CarbonPATH's scalar model.

A frozen copy of the framework-free scalar model of ``repro_torch/core``
(``evaluate``, ``techdb``, ``carbon``, ``cost``, ``d2d``, ``floorplan``,
``scalesim``, ``comm``, ``schedule``, ``templates``, ``workload``,
``chiplet``, ``system``), of the encoded design space
(``repro_torch/pathfinding/space.py``: decode, sampling, validity) and of
the tempering search's seeding (``seeding.py``, from
``repro_torch/core/sa.py``), taken at commit ``fc95425``; and the
tempering search's rules (``tempering.py``) with the threefry stream they
draw from (``threefry.py``), written from their statement. The imports
differ, and in two places the copy departs from its source:

- ``comm.resolve_comm`` / ``schedule.resolve_schedule`` read no
  environment variable: the benchmark names both models;
- Algorithm 1 (``workload.tile_and_assign``) sums the core powers by a
  sequential fold in sorted order, as its source documents and as the
  batched evaluators do. The source calls the built-in ``sum()``, which
  compensates its rounding from Python 3.12 on; where two fractional
  parts tie to an ulp, the leftover tile then goes to another core (about
  one random design in 1,200 of workload 1).

It is numpy and Python only and imports nothing of the program. It works
out the normalizer and every cost again from the encoded designs that
the program returned, one distinct design at a time.

``Reference(config, float32=True)`` is the precision control: the same
model with every float of the technology database as ``numpy.float32``,
so that each product with a table value, and so every metric, the
normalizer and the Eq. 17 cost, is rounded to float32 (NumPy's scalar
promotion keeps a float32 operand's type against a Python float).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

import numpy as np

from .evaluate import evaluate
from .scalesim import SimCache
from .seeding import random_system, seed_noc, seed_schedule
from .space import DesignSpace
from .techdb import DEFAULT_DB
from .templates import METRIC_FIELDS, TEMPLATES
from .workload import workload

def _as_float32(obj):
    """``obj`` with every Python float inside it as ``numpy.float32``."""
    if isinstance(obj, bool) or obj is None:
        return obj
    if isinstance(obj, float):
        return np.float32(obj)
    if isinstance(obj, dict):
        return {k: _as_float32(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_as_float32(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _as_float32(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _median(sorted_vals: np.ndarray):
    """True median of a sorted array, floored to 1 when not positive (the
    normalizer's ``_positive_median``), in the array's own type."""
    n = len(sorted_vals)
    if n % 2:
        mid = sorted_vals[n // 2]
    else:
        mid = sorted_vals.dtype.type(0.5) * (sorted_vals[n // 2 - 1]
                                             + sorted_vals[n // 2])
    return mid if mid > 0 else sorted_vals.dtype.type(1.0)


class Reference:
    """One configuration's design space, workloads and Eq. 17 cost.

    ``config`` is the benchmark's configuration file: ``workloads`` (the
    paper's GEMM workload ids), ``template``, ``comm``, ``schedule``,
    ``max_chiplets``, ``norm_samples`` and ``norm_seed``."""

    def __init__(self, config: dict, float32: bool = False):
        self.dtype = np.float32 if float32 else np.float64
        self.db = _as_float32(DEFAULT_DB) if float32 else DEFAULT_DB
        self.space = DesignSpace(self.db, int(config["max_chiplets"]),
                                 comm=config["comm"],
                                 schedule=config["schedule"])
        self.workloads = [workload(int(w)) for w in config["workloads"]]
        self.weights = np.asarray(TEMPLATES[config["template"]].weights,
                                  self.dtype)
        self.norm_samples = int(config["norm_samples"])
        self.norm_seed = int(config["norm_seed"])
        self.cache = SimCache()
        self._norms: Dict[int, tuple] = {}

    def metrics(self, enc: np.ndarray, wi: int = 0) -> np.ndarray:
        """``[P, 6]`` metrics (``METRIC_FIELDS`` order) of encoded rows
        under workload ``wi``, one scalar evaluation a row."""
        wl = self.workloads[wi]
        out = np.empty((len(enc), len(METRIC_FIELDS)), self.dtype)
        for i, sys in enumerate(self.space.decode_many(enc)):
            m = evaluate(sys, wl, self.db, cache=self.cache)
            out[i] = [getattr(m, f) for f in METRIC_FIELDS]
        return out

    def normalizer(self, wi: int = 0):
        """``(mins, medians)`` of the Eq. 17 normalizer: the metrics of
        ``norm_samples`` random valid designs drawn from ``norm_seed``."""
        if wi not in self._norms:
            pop = self.space.sample(self.norm_samples, key=self.norm_seed)
            x = np.sort(self.metrics(pop, wi), axis=0)
            mins = x[0].copy()
            meds = np.array([_median(x[:, j]) for j in range(x.shape[1])],
                            self.dtype)
            self._norms[wi] = (mins, meds)
        return self._norms[wi]

    def costs(self, enc: np.ndarray, wi: int = 0) -> np.ndarray:
        """Eq. 17 costs of encoded rows."""
        return self.score(enc, wi)[0]

    def score(self, enc: np.ndarray, wi: int = 0):
        """Eq. 17 costs ``[P]`` and objective vectors ``[P, 3]``
        (``latency_s``, ``dollar``, embodied plus operational carbon) of
        encoded rows, each distinct row evaluated once."""
        enc = np.asarray(enc)
        uniq, inv = np.unique(enc, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mins, meds = self.normalizer(wi)
        x = self.metrics(uniq, wi)
        cost = ((x - mins) / meds * self.weights).sum(axis=1)
        vec = np.stack([x[:, 2], x[:, 3], x[:, 4] + x[:, 5]], axis=1)
        return cost[inv], vec[inv]

    def valid(self, enc: np.ndarray) -> np.ndarray:
        """Whether each encoded row is a valid design of the space."""
        return self.space.validity_mask(enc)

    def seed_population(self, key: int, n: int) -> np.ndarray:
        """The ``n`` encoded rows that ``ParallelTempering`` seeds its
        chains with under ``key``: ``random_system`` draws from one
        ``random.Random(key)``, with the neutral NoC and schedule
        assignments on live mesh-NoC and window spaces."""
        rng = random.Random(key)
        chains: List = [random_system(rng, self.db, self.space.max_chiplets)
                        for _ in range(n)]
        if self.space.noc_live:
            chains = [seed_noc(s) for s in chains]
        if self.space.sched_live:
            chains = [seed_schedule(s) for s in chains]
        return self.space.encode_many(chains)


def rows_in(rows: np.ndarray, pool: Sequence[np.ndarray]) -> np.ndarray:
    """Whether each row of ``rows`` equals some row of ``pool``."""
    seen = {np.asarray(r).tobytes() for r in pool}
    return np.array([np.asarray(r).tobytes() in seen for r in rows], bool)
