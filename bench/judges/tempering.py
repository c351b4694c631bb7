"""The check of a tempering search's calls against the plain reference.

:class:`Capture` keeps, for each call of the window, what the timed path
handed back: the seed population and the ``DevicePTResult`` of the
engine (``DeviceEvaluator.parallel_tempering``), every design it
evaluated with its objective vector (the frontier archive's input), and
the call's frontier. :func:`judge` compares, with the traffic file's strategy
parameters (``n_chains``, ``t_max``, ``t_min``, ``swap_every``):

- ``cost_gap``: the widest relative gap between an answer of the program
  and the reference's for the same design: every final chain's cost and
  the best cost of every call, the frontier's objective vectors, and in
  the replayed call every evaluated design's objective vector, the final
  costs and the coldest chain's cost after each sweep. A gap is taken
  against the larger of the reference value and the median of the
  checked values, so that a near-zero cost does not blow it up.
- ``invalid``: returned or evaluated designs that are not valid designs
  of the space.
- ``replay``: seed designs that differ from the reference's seeding of
  the call's key.
- ``unmoved``: the largest share, over the calls, of final chains that
  are still one of that call's seed designs.
- ``trajectory``: in one call drawn from the run's seed, the final
  chains and the best design that differ from the reference's replay of
  the search's rules (``bench/reference/tempering.py``: the ladder,
  Metropolis acceptance, the best design seen, the replica exchange) on
  the program's proposals and the reference's costs; and in every call,
  one if the best cost lies above a final chain's.
- ``frontier``: frontier designs that the call never evaluated, and in
  the replayed call, frontier designs that another evaluated design
  dominates by the reference's vectors (by more than one part in 10^12
  on an axis, so that round-off ties do not count).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench.harness.spans import Wrap
from bench.reference import Reference, rows_in
from bench.reference.tempering import ladder, replay

ENGINE = ("repro_torch.pathfinding.device", "DeviceEvaluator",
          "parallel_tempering")
ARCHIVE = ("repro_torch.pathfinding.pareto", "ParetoArchive", "insert")
DOMINANCE_RTOL = 1e-12


def _owner(path):
    import importlib

    return getattr(importlib.import_module(path[0]), path[1]), path[2]


class Capture:
    """What each call handed back; its :meth:`wraps` go around the
    window."""

    def __init__(self):
        self.calls: List[dict] = []

    def wraps(self) -> List[Wrap]:
        return [Wrap(*_owner(ENGINE), on_call=self._engine),
                Wrap(*_owner(ARCHIVE), on_call=self._archive)]

    def start_call(self, key: int) -> None:
        self.calls.append(dict(key=key, enc=[], vec=[]))

    def end_call(self, result) -> None:
        front = result.frontier
        cur = self.calls[-1]
        if front is not None:
            cur["front_enc"] = np.asarray(front.encoded)
            cur["front_vec"] = np.asarray(front.vectors)

    def _engine(self, args, kwargs, out) -> None:
        cur = self.calls[-1]
        cur["v0"] = np.atleast_2d(np.asarray(args[1], np.int32))
        cur["result"] = out

    def _archive(self, args, kwargs, out) -> None:
        self.calls[-1]["enc"].append(np.asarray(args[1], np.int32))
        self.calls[-1]["vec"].append(np.asarray(args[2], np.float64))


def gap(prog, ref) -> float:
    prog = np.asarray(prog, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    if not len(ref):
        return 0.0
    scale = max(float(np.median(np.abs(ref))), np.finfo(np.float64).tiny)
    den = np.maximum(np.abs(ref), scale)
    return float(np.max(np.abs(prog - ref) / den))


def dominated(front: np.ndarray, pool: np.ndarray,
              rtol: float = DOMINANCE_RTOL) -> np.ndarray:
    """Whether some row of ``pool`` dominates each row of ``front`` (no
    worse on every axis, better on one, both by more than ``rtol`` of the
    front row's value)."""
    out = np.zeros(len(front), bool)
    for i, p in enumerate(front):
        tol = rtol * np.abs(p)
        le = (pool <= p + tol).all(axis=1)
        lt = (pool < p - tol).any(axis=1)
        out[i] = bool((le & lt).any())
    return out


def samples_of(call: dict, n: int) -> tuple:
    """The call's evaluated designs and vectors as ``[1 + sweeps, n, W]``
    and ``[1 + sweeps, n, 3]`` (the seed population first)."""
    enc = np.concatenate(call["enc"])
    vec = np.concatenate(call["vec"])
    return enc.reshape(-1, n, enc.shape[1]), vec.reshape(-1, n, 3)


def replayed_call(seed: int, n_calls: int) -> int:
    """The call whose search is replayed whole, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    return int(rng.integers(n_calls))


def judge(ref: Reference, calls: List[dict], seed: int,
          traffic: dict) -> Dict[str, float]:
    p = traffic["strategy"]["params"]
    n = int(p["n_chains"])
    temps = ladder(n, float(p["t_max"]), float(p["t_min"]))
    whole = replayed_call(seed, len(calls))
    cost_gap = unmoved = 0.0
    invalid = bad_seed = trajectory = frontier = 0
    for ci, c in enumerate(calls):
        res = c["result"]
        seeds = ref.seed_population(c["key"], n)
        bad_seed += int((seeds != c["v0"]).any(axis=1).sum())
        front_enc = c.get("front_enc", np.zeros((0, seeds.shape[1]), int))
        front_vec = c.get("front_vec", np.zeros((0, 3)))
        rows = np.concatenate([res.final_enc, res.best_enc[None], front_enc])
        cost, vec = ref.score(rows)
        cost_gap = max(cost_gap,
                       gap(res.final_costs, cost[:n]),
                       gap([res.best_cost], cost[n:n + 1]),
                       gap(front_vec, vec[n + 1:]))
        invalid += int((~ref.valid(rows)).sum())
        unmoved = max(unmoved, float(rows_in(res.final_enc, seeds).mean()))
        trajectory += int(res.best_cost > res.final_costs.min())
        enc, pvec = samples_of(c, n)
        frontier += int((~rows_in(front_enc, enc.reshape(-1, enc.shape[2])))
                        .sum())
        if ci != whole:
            continue
        bad_seed += int((enc[0] != seeds).any(axis=1).sum())
        flat = enc.reshape(-1, enc.shape[2])
        invalid += int((~ref.valid(flat)).sum())
        scost, svec = ref.score(flat)
        cost_gap = max(cost_gap, gap(pvec, svec))
        scost = scost.reshape(enc.shape[:2])
        r = replay(c["key"], seeds, scost[0], enc[1:], scost[1:], temps,
                   int(p["swap_every"]))
        trajectory += int((r["final_enc"] != res.final_enc).any(axis=1).sum())
        trajectory += int((r["best_enc"] != res.best_enc).any())
        cost_gap = max(cost_gap, gap(res.final_costs, r["final_costs"]),
                       gap(res.history, r["history"]))
        frontier += int(dominated(vec[n + 1:], svec).sum())
    return dict(cost_gap=cost_gap, invalid=invalid, replay=bad_seed,
                unmoved=unmoved, trajectory=trajectory, frontier=frontier)


def control(ref32: Reference, calls: List[dict], traffic: dict
            ) -> List[dict]:
    """The calls with the program's answers replaced by those of the
    reference in float32 (``ref32``) for the same designs: its costs and
    vectors, and its own replay of the search's rules on its own costs."""
    import copy

    p = traffic["strategy"]["params"]
    n = int(p["n_chains"])
    temps = ladder(n, float(p["t_max"]), float(p["t_min"]))
    out = copy.deepcopy(calls)
    for c in out:
        res = c["result"]
        enc, _ = samples_of(c, n)
        flat = enc.reshape(-1, enc.shape[2])
        scost, svec = ref32.score(flat)
        c["vec"] = [svec.astype(np.float64)]
        c["enc"] = [flat]
        scost = scost.reshape(enc.shape[:2])
        r = replay(c["key"], c["v0"], scost[0], enc[1:], scost[1:], temps,
                   int(p["swap_every"]))
        res.final_enc, res.best_enc = r["final_enc"], r["best_enc"]
        res.history = list(r["history"])
        cost, _ = ref32.score(np.concatenate([res.final_enc,
                                              res.best_enc[None]]))
        res.final_costs = cost[:n].astype(np.float64)
        res.best_cost = float(cost[n])
        if "front_enc" in c and len(c["front_enc"]):
            c["front_vec"] = ref32.score(c["front_enc"])[1].astype(
                np.float64)
    return out
