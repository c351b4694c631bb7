"""Spans from outside the program, and the device trace of one window.

:class:`Wrap` replaces ``owner.name`` (a class's method or a module's
function) for the lifetime of a ``with`` block, as the ``_Recorder`` of
the program's ``chip_smoke.py`` does: each call can be timed to a
synchronize, labelled as a host range in the profiler's trace, and handed
with its arguments and result to a callback.

:class:`ProfileWindow` starts ``torch.profiler`` on the entry of the
``skip``-th call of a wrapped function and stops it on the entry of the
``skip + count``-th, synchronizing at both ends, so the traced window is a
whole number of the loop's periods. :func:`read_trace` reduces its events
to the device's busy time, its operations by name, and the idle gaps
between them (and before the first and after the last, to the traced
window's first and last event) by the host range open at the time.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


class Wrap:
    """``owner.name`` wrapped while the block is open."""

    def __init__(self, owner, name: str, device: str = "cpu",
                 timed: bool = False, label: Optional[str] = None,
                 on_call: Optional[Callable] = None,
                 on_enter: Optional[Callable] = None):
        self.owner, self.name, self.device = owner, name, device
        self.timed, self.label = timed, label
        self.on_call, self.on_enter = on_call, on_enter
        self.seconds: List[float] = []

    def __enter__(self):
        real = getattr(self.owner, self.name)
        self.real = real

        def wrapper(*args, **kwargs):
            if self.on_enter is not None:
                self.on_enter()
            if self.timed:
                _sync(self.device)
                t = time.perf_counter()
            with label(self.label):
                out = real(*args, **kwargs)
            if self.timed:
                _sync(self.device)
                self.seconds.append(time.perf_counter() - t)
            if self.on_call is not None:
                self.on_call(args, kwargs, out)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def label(name: Optional[str]):
    if name is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class ProfileWindow:
    """Profiles calls ``skip`` to ``skip + count - 1`` of one function;
    :meth:`hook` goes as ``on_enter`` of that function's :class:`Wrap`."""

    def __init__(self, device: str, skip: int, count: int):
        self.device, self.skip, self.count = device, skip, count
        self.calls = 0
        self.prof = None
        self.t0 = self.t1 = None
        self.periods = 0

    def hook(self) -> None:
        if self.calls == self.skip and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(self.device)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.calls == self.skip + self.count:
            self.stop()
        self.calls += 1

    def stop(self) -> None:
        if self.prof is not None and self.t1 is None:
            _sync(self.device)
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.periods = min(self.calls, self.skip + self.count) - self.skip


def warm_profiler(device: str) -> None:
    """Start and stop the profiler once, so that its first start (the
    tracer's set-up) falls before the profiled call's window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        _sync(device)


def read_trace(window: ProfileWindow, top: int = 10) -> Optional[Dict]:
    """Busy seconds, operations by name and idle gaps by host range of a
    stopped :class:`ProfileWindow`; ``None`` when nothing was traced."""
    if window.prof is None or window.t1 is None:
        return None
    from torch.autograd import DeviceType

    dev, host = [], []
    first, last = float("inf"), float("-inf")
    for e in window.prof.events():
        tr = e.time_range
        first, last = min(first, tr.start), max(last, tr.end)
        if e.name.startswith("bench."):
            # a range's twin on the device's timeline is no operation
            if e.device_type != DeviceType.CUDA:
                host.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name[:160]))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
    dev.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    if dev and dev[0][0] > first:
        gaps.append((first, dev[0][0]))
    for s, t, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, t
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy_us += cur_e - cur_s
        if last > cur_e:
            gaps.append((cur_e, last))
    host.sort(key=lambda h: h[1] - h[0])     # innermost range first
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = next((n for s, t, n in host if s <= mid <= t), "bench.other")
        idle[name] += (b - a) * 1e-6
    return dict(
        busy_s=busy_us * 1e-6,
        window_s=window.t1 - window.t0,
        periods=window.periods,
        n_device_ops=len(dev),
        device_ops=sorted(by_name.items(), key=lambda k: -k[1])[:top],
        op_seconds=[(n, (t - s) * 1e-6) for s, t, n in dev
                    if "prefix_select" in n],
        idle_gaps=sorted(idle.items(), key=lambda k: -k[1])[:top],
    )
