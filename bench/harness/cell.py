"""One cell, run once: set-up, the measured window, the traced window,
the check and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration file ``bench/configs/<config>.json`` (the design space and
its normalizer) and a traffic file ``bench/traffic/<traffic>.json``.
``bench/cells/<cell>.json`` holds what belongs to the cell alone: its
frozen work counts and the limits of its check. The traffic file names,
besides its parameters, the modules that the harness finds by name:

- ``driver``: ``bench/drivers/<driver>.py``, how a window's calls are
  issued (its ``Driver`` warms up, runs the window and one more call);
- ``judge``: ``bench/judges/<judge>.py``, what of each call is kept
  (``Capture``) and how it is held to the reference (``judge``);
- ``spans``: the program's functions timed in a traced run, by label;
- ``profile`` and ``labels``: the function whose calls bound the
  profiled window, and the host ranges that name its idle gaps.

Each metric of ``BENCHMARK.json``, end to end or per layer, is read by
``bench/metrics/<metric>.py`` from what the run recorded. This module
only puts these in order.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``bench/<folder>/<name>.py`` as a module."""
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> dict:
    """The cell's entry, its configuration, its traffic and its own
    file."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    own = load_json(BENCH / "cells" / f"{name}.json")
    return dict(
        name=name, chips=int(w["chips"]), spec=spec,
        config=load_json(ROOT / configs[w["config"]]["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        work=own.get("work"), limits=own["limits"])


def resolve(path: str):
    """``module:attr.attr`` as ``(owner, name)``."""
    mod, attr = path.split(":")
    owner = importlib.import_module(mod)
    parts = attr.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Program:
    """The system under test: the facade over the cell's design space."""

    def __init__(self, cell: dict, device: str):
        from repro_torch.core import workload
        from repro_torch.core.techdb import DEFAULT_DB
        from repro_torch.pathfinding import DesignSpace, Pathfinder

        cfg = cell["config"]
        self.space = DesignSpace(DEFAULT_DB, int(cfg["max_chiplets"]),
                                 comm=cfg["comm"], schedule=cfg["schedule"])
        self.pf = Pathfinder(workload(int(cfg["workloads"][0])),
                             cfg["template"], space=self.space,
                             torch_device=device)
        self.norm_args = (int(cfg["norm_samples"]), int(cfg["norm_seed"]))

    def fit(self) -> None:
        self.pf.fit_normalizer(*self.norm_args)


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


class Hooks:
    """Around each call a driver issues: the judge's capture, and the
    seconds of each timed span inside the call."""

    def __init__(self, capture, spans: Dict[str, object], device: str):
        self.capture, self.spans, self.device = capture, spans, device
        self.marks: Dict[str, int] = {}

    def sync(self) -> None:
        sync(self.device)

    def before(self, key: int) -> None:
        self.capture.start_call(key)
        self.marks = {k: len(w.seconds) for k, w in self.spans.items()}

    def after(self, result) -> dict:
        self.capture.end_call(result)
        return dict(spans={k: sum(w.seconds[self.marks[k]:])
                           for k, w in self.spans.items()})


def profiled(traffic: dict, device: str):
    """The profiler's window over the periods that the traffic file's
    ``profile`` names, and the wraps that open and label it."""
    from bench.harness import spans

    prof = traffic["profile"]
    window = spans.ProfileWindow(device, int(prof["skip"]),
                                 int(prof["count"]))
    wraps = [spans.Wrap(*resolve(prof["function"]), label=prof["label"],
                        on_enter=window.hook)]
    for path, label in traffic.get("labels", {}).items():
        wraps.append(spans.Wrap(*resolve(path), label=label))
    return window, wraps


def read_metrics(spec: dict, kind: str, cell: str, reading: dict
                 ) -> Dict[str, dict]:
    """The cell's metrics of one kind (``end_to_end`` or ``per_layer``),
    each by its reader; a reader that finds nothing leaves it out."""
    out = {}
    for m in spec[kind]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (and each limit given)."""
    return all(k in limits and numbers[k] <= limits[k] for k in numbers)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        traffic_override: Optional[dict] = None) -> dict:
    """Run the cell once and return the result line's object. ``device``
    other than ``cuda`` and ``traffic_override`` serve the tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from bench.harness import spans, work
    from repro_torch.pathfinding import device as dev_mod

    cell = load_cell(cell_name)
    traffic = dict(cell["traffic"], **(traffic_override or {}))
    program = Program(cell, device)
    judge = load_module("judges", traffic["judge"])
    capture = judge.Capture()
    timed = {label: spans.Wrap(*resolve(path), device=device, timed=True,
                               label=label)
             for label, path in traffic["spans"].items()} if trace else {}
    hooks = Hooks(capture, timed, device)
    driver = load_module("drivers", traffic["driver"]).Driver(
        program, traffic, hooks)

    # -- set-up: the kernel, the normalizer, one warm call ---------------
    if device == "cuda":
        from repro_torch.kernels.prefix_gather import ops as kops

        kops.build()
    program.fit()
    grabbed = []
    grab = spans.Wrap(dev_mod, "prefix_select",
                      on_call=lambda a, k, o: grabbed or grabbed.append(
                          tuple(t.clone() for t in a)))
    with grab:
        driver.warm(seed)
    bound = work.prefix_select_bound(grabbed.pop())
    setup_s = time.perf_counter() - t_start

    # -- the window, and in a traced run one profiled call after it ------
    wraps = capture.wraps() + list(timed.values())
    for w in wraps:
        w.__enter__()
    try:
        record = driver.window(seed, seconds)
        window = None
        if trace:
            # the profiler's first start comes after the window's spans:
            # once started, it slows every launch that follows
            spans.warm_profiler(device)
            window, pwraps = profiled(traffic, device)
            for w in pwraps:
                w.__enter__()
            try:
                with spans.label("bench.call"):
                    driver.extra(seed, len(record["calls"]))
            finally:
                for w in reversed(pwraps):
                    w.__exit__(None, None, None)
                window.stop()
    finally:
        for w in reversed(wraps):
            w.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    # -- what the window's process loaded ---------------------------------
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        raise SystemExit(f"forbidden modules loaded: {loaded}")

    # -- the metrics ------------------------------------------------------
    dev_info = dict(platform="gpu" if device == "cuda" else device,
                    kind=(torch.cuda.get_device_name(0)
                          if device == "cuda" else device),
                    count=cell["chips"], memory_peak_bytes=int(peak))
    tr = spans.read_trace(window) if window is not None else None
    reading = dict(record, setup_s=setup_s, trace=tr, bound=bound,
                   work=cell["work"], width=program.space.width)
    out_metrics = read_metrics(cell["spec"],
                               "per_layer" if trace else "end_to_end",
                               cell_name, reading)
    breakdown = None
    if tr is not None:
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = dict(device_ops=[list(k) for k in tr["device_ops"]],
                         idle_gaps=[list(k) for k in tr["idle_gaps"]])

    # -- the check, once the program's state is freed --------------------
    del program, driver, hooks, record
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from bench.reference import Reference

    calls = reading["calls"]
    print("window: %d calls of %s s; set-up %.3f s" % (
        len(calls), [round(c["call_s"], 3) for c in calls], setup_s),
          file=sys.stderr)
    t_check = time.perf_counter()
    numbers = judge.judge(Reference(cell["config"]), capture.calls, seed,
                          traffic)
    print("check: %.1f s" % (time.perf_counter() - t_check),
          file=sys.stderr)
    limits = cell["limits"]
    checks = {k: dict(value=v, limit=limits.get(k)) for k, v in
              numbers.items()}
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    line = dict(correct=verdict(numbers, limits), attempted=len(calls),
                failed=0, metrics=out_metrics, device=dev_info)
    if breakdown is not None:
        line["breakdown"] = breakdown
    # the numbers compared, each beside its limit, come last
    line["checks"] = checks
    return line
