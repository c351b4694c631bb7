"""One client in a closed loop: the facade's ``search`` with the traffic
file's ``strategy`` (a class of ``repro_torch.pathfinding`` and its
``params``) and ``budget``, the next call as soon as the last returns
(set-up's warm call takes the file's ``warm`` parameters over them).
Call ``i`` of seed ``s`` takes the key ``s * KEY_STRIDE + i``; set-up's
warm call takes the last key of the seed's range, which no window
reaches."""
from __future__ import annotations

import importlib
import time
from typing import Dict, List

KEY_STRIDE = 1000


def build(spec: dict):
    """The traffic file's strategy: its ``class`` of
    ``repro_torch.pathfinding``, built from its ``params``."""
    mod = importlib.import_module("repro_torch.pathfinding")
    return getattr(mod, spec["class"])(**spec["params"])


class Driver:
    """``hooks`` has ``before(key)`` and ``after(result) -> dict``, the
    cell's capture and span accounting around each call, and
    ``sync()``."""

    def __init__(self, program, traffic: dict, hooks):
        self.pf = program.pf
        spec = traffic["strategy"]
        self.strategy = build(spec)
        # set-up's warm call: the same strategy with the traffic file's
        # ``warm`` parameters (fewer sweeps, the same shapes)
        self.warm_strategy = build(dict(spec, params=dict(
            spec["params"], **traffic.get("warm", {}))))
        self.budget = traffic.get("budget")
        self.hooks = hooks

    def call(self, key: int, strategy=None):
        return self.pf.search(strategy or self.strategy, budget=self.budget,
                              key=key)

    def warm(self, seed: int) -> None:
        self.call(seed * KEY_STRIDE + KEY_STRIDE - 1, self.warm_strategy)
        self.hooks.sync()

    def _timed(self, key: int) -> Dict[str, float]:
        self.hooks.before(key)
        t = time.perf_counter()
        res = self.call(key)
        self.hooks.sync()
        end = time.perf_counter()
        # a tempering search returns its coldest chain's cost after each
        # sweep, after the seed population's best
        rec = dict(call_s=end - t, end=end, evaluations=int(res.evaluations),
                   sweeps=len(res.history) - 1)
        rec["rows"] = rec["evaluations"] // (rec["sweeps"] + 1)
        rec.update(self.hooks.after(res))
        return rec

    def window(self, seed: int, seconds: float) -> Dict:
        """Calls back to back until ``seconds`` have passed at a call's
        end; the window closes at the last call's end."""
        calls: List[Dict[str, float]] = []
        self.hooks.sync()
        t0 = time.perf_counter()
        while not calls or calls[-1]["end"] - t0 < seconds:
            calls.append(self._timed(seed * KEY_STRIDE + len(calls)))
        return dict(calls=calls, window_s=calls[-1]["end"] - t0,
                    evaluations=sum(c["evaluations"] for c in calls))

    def extra(self, seed: int, n_done: int) -> Dict[str, float]:
        """One more call after the window (a traced run's profiled
        call), with the next key."""
        return self._timed(seed * KEY_STRIDE + n_done)

