"""Faults planted in the timed path, to show that a run's check catches
each of them (``bench/tests/test_bench_faults.py``, on the CPU at a tiny
size; ``bench/readings.py --faults``, on the card at the cell's size).

- ``unchanged``: a step returns its state unchanged (``_propose`` hands
  back the incumbent rows);
- ``half``: half of the batch is left out of the evaluation and its costs
  are the mean over the rest;
- ``altered``: every cost is altered by one part in a million where
  ``_eval_cost`` produces it;
- ``no_exchange``: the replica exchange is skipped;
- ``accept_all``: the engine runs on a ladder raised 10^300-fold, so
  that it accepts every proposal (and every exchange);
- ``best_not_min``: the search reports its hottest final chain as its
  best design;
- ``seed_shifted``: the engine starts each chain from its neighbour's
  seed design;
- ``archive_first``: the frontier archive takes in only the first block
  of designs it is fed.

The cells run on one chip, so no exchange between chips can be left
out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered", "no_exchange", "accept_all",
          "best_not_min", "seed_shifted", "archive_first")


@contextlib.contextmanager
def planted(fault: str):
    import numpy as np
    import torch

    from repro_torch.pathfinding import device as dev_mod
    from repro_torch.pathfinding.pareto import ParetoArchive

    if fault not in FAULTS:
        raise SystemExit(f"unknown fault {fault!r}")
    cls = dev_mod.DeviceEvaluator
    saved = [(dev_mod, "_propose", dev_mod._propose),
             (dev_mod, "_eval_cost", dev_mod._eval_cost),
             (dev_mod, "_exchange", dev_mod._exchange),
             (cls, "parallel_tempering", cls.parallel_tempering),
             (ParetoArchive, "insert", ParetoArchive.insert)]
    real_eval, real_pt = dev_mod._eval_cost, cls.parallel_tempering
    real_insert = ParetoArchive.insert
    if fault == "unchanged":
        dev_mod._propose = lambda key, v, tb, cfg, *a, **k: v.clone()
    elif fault in ("half", "altered"):
        def eval_cost(v, *args, **kwargs):
            mets, cost, vec = real_eval(v, *args, **kwargs)
            if fault == "altered":
                return mets, cost * (1 + 1e-6), vec
            h = cost.shape[0] // 2
            kept = cost[:h]
            cost = torch.cat([kept, kept.mean().expand(cost.shape[0] - h)])
            return mets, cost, vec

        dev_mod._eval_cost = eval_cost
    elif fault == "no_exchange":
        dev_mod._exchange = lambda *a, **k: None
    elif fault == "accept_all":
        def pt(self, v0, temps, *args, **kwargs):
            return real_pt(self, v0, np.asarray(temps) * 1e300, *args,
                           **kwargs)

        cls.parallel_tempering = pt
    elif fault == "best_not_min":
        def pt(self, *args, **kwargs):
            res = real_pt(self, *args, **kwargs)
            res.best_enc = res.final_enc[0].copy()
            res.best_cost = float(res.final_costs[0])
            return res

        cls.parallel_tempering = pt
    elif fault == "seed_shifted":
        def pt(self, v0, *args, **kwargs):
            return real_pt(self, np.roll(np.asarray(v0), 1, axis=0), *args,
                           **kwargs)

        cls.parallel_tempering = pt
    elif fault == "archive_first":
        def insert(self, encoded, vectors):
            n = min(len(encoded), 512)
            return real_insert(self, encoded[:n], vectors[:n])

        ParetoArchive.insert = insert
    try:
        yield
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)
