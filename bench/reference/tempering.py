"""The rules of a parallel-tempering search, replayed: the temperature
ladder, Metropolis acceptance, the best design seen, and the sequential
replica exchange of adjacent temperatures, as ``ParallelTempering``
states them (Sec V-A's simulated annealing, run as replicas).

The replay draws its uniforms from the search key's threefry stream
(``threefry.py``): each sweep splits the key into the next key, the
proposal's key, the acceptance key and the exchange key. The proposals
themselves are the program's (the designs it evaluated), so the replay
holds everything after the proposal to the rules, on the costs that the
caller works out for those designs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import threefry


def ladder(n: int, t_max: float, t_min: float) -> np.ndarray:
    """The geometric ladder from ``t_max`` (chain 0) to ``t_min`` (the
    coldest chain, last)."""
    ratio = (t_min / t_max) ** (1.0 / max(1, n - 1))
    return np.array([t_max * ratio ** i for i in range(n)], np.float64)


def _exchange(v: np.ndarray, costs: np.ndarray, inv_t: np.ndarray,
              us: np.ndarray) -> None:
    """Adjacent pairs (j, j + 1) in order, each swapping with probability
    ``min(1, exp[(1/T_j - 1/T_j+1)(c_j - c_j+1)])``."""
    for j in range(len(costs) - 1):
        d = (inv_t[j] - inv_t[j + 1]) * (costs[j] - costs[j + 1])
        if d >= 0 or us[j] < np.exp(min(d, 0.0)):
            costs[[j, j + 1]] = costs[[j + 1, j]]
            v[[j, j + 1]] = v[[j + 1, j]]


def replay(key: int, v0: np.ndarray, cost0: np.ndarray,
           proposals: np.ndarray, pcosts: np.ndarray, temps: np.ndarray,
           swap_every: int) -> Dict[str, np.ndarray]:
    """The search from the seed population ``v0`` (``[n, W]``, costs
    ``cost0``) through the proposals ``[sweeps, n, W]`` (costs
    ``[sweeps, n]``): the final population and costs, the best design and
    its cost, and the coldest chain's cost after each sweep, after the
    best cost of the seed population."""
    v = np.array(v0, copy=True)
    costs = np.array(cost0, np.float64, copy=True)
    n = len(costs)
    inv_t = 1.0 / temps
    bi = int(np.argmin(costs))
    best_v, best_c = v[bi].copy(), costs[bi]
    history = [costs.min()]
    k = threefry.prng_key(key)
    for sweep in range(len(proposals)):
        k, _, ka, ksw = threefry.split(k, 4)
        prop, pc = proposals[sweep], np.asarray(pcosts[sweep], np.float64)
        u = threefry.uniform(ka, n)
        delta = pc - costs
        with np.errstate(over="ignore"):
            accept = (delta <= 0) | (
                u < np.exp(-delta / np.maximum(temps, 1e-12)))
        v = np.where(accept[:, None], prop, v)
        costs = np.where(accept, pc, costs)
        acc = np.where(accept, pc, np.inf)
        i = int(np.argmin(acc))
        if acc[i] < best_c:
            best_c, best_v = acc[i], prop[i].copy()
        us = threefry.uniform(ksw, max(n - 1, 1))
        if sweep % swap_every == 0:
            _exchange(v, costs, inv_t, us)
        history.append(costs[-1])
    return dict(final_enc=v, final_costs=costs, best_enc=best_v,
                best_cost=float(best_c), history=np.asarray(history))
