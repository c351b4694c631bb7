"""The program's own spans on the clock of a profiler's trace, and the
readings they give.

A recording of ``repro_torch.runtime.trace`` times the program's spans
with ``time.perf_counter_ns()`` and keeps one anchor, a
``(perf_counter_ns, time_ns)`` pair read together. A profiler's events
carry microseconds from ``kineto_results.trace_start_ns()``, which lies
on the ``time.time_ns()`` epoch clock. So a span starting at ``t`` on
the program's clock lies at ``(anchor_wall + t - anchor_pc -
trace_start_ns) / 1000`` in the trace.

:func:`join` takes a stopped profiler and the spans recorded over the
same call, and gives each of the trace's idle gaps on the device (as
:func:`bench.harness.spans.read_trace` finds them) and each of the
host's launch and copy calls to the innermost program span open at its
midpoint. The program opens no profiler range, so the trace's own
metrics do not move with its spans.

:func:`readings` turns a recording's summary into the per-layer numbers
of the engine: times a sweep, a call or an exchange round, and the
blocking reads and the bytes they bring back.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the host's runtime calls that put work on the device's queue
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
# the root of the program's spans and the sweep below it
SWEEP = "pf.sweep"


def to_trace_us(rec_spans: dict, trace_start_ns: int) -> List[tuple]:
    """``(start_us, end_us, name, parent)`` of each recorded span on the
    trace's clock."""
    pc, wall = rec_spans["anchor"]
    off = wall - pc - trace_start_ns
    return [((s.start_ns + off) * 1e-3, (s.end_ns + off) * 1e-3, s.name,
             s.parent) for s in rec_spans["spans"]]


def segments(spans: List[tuple]) -> Tuple[List[float], List[Optional[str]]]:
    """The trace's time cut where the innermost open span changes:
    ``(starts, paths)``, the path of segment i (``root/.../innermost``,
    ``None`` outside every span) holding from ``starts[i]`` to
    ``starts[i + 1]``. Spans nest, as those of one thread do."""
    paths = []
    for s, _, name, parent in spans:
        paths.append(name if parent < 0 else f"{paths[parent]}/{name}")
    edges = sorted([(s, 1, i) for i, (s, _, _, _) in enumerate(spans)]
                   + [(t, 0, i) for i, (_, t, _, _) in enumerate(spans)])
    starts, out, stack = [], [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        out.append(paths[stack[-1]] if stack else None)
    return starts, out


def path_at(starts: List[float], paths: List[Optional[str]], t: float
            ) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    return paths[i] if i >= 0 else None


def device_gaps(events, device_type) -> List[Tuple[float, float]]:
    """The idle gaps between the operations of ``device_type``, and
    before the first and after the last to the trace's first and last
    event, as ``read_trace`` counts them (µs)."""
    dev = []
    first, last = float("inf"), float("-inf")
    for e in events:
        tr = e.time_range
        first, last = min(first, tr.start), max(last, tr.end)
        if (e.device_type == device_type
                and not e.name.startswith("bench.")):
            dev.append((tr.start, tr.end))
    dev.sort()
    gaps, cur = [], None
    if dev and dev[0][0] > first:
        gaps.append((first, dev[0][0]))
    for s, t in dev:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = t if cur is None else max(cur, t)
    if cur is not None and last > cur:
        gaps.append((cur, last))
    return gaps


def join(prof, rec_spans: dict, device_type=None,
         runtime_calls=RUNTIME_CALLS) -> Dict[str, object]:
    """Idle seconds and runtime calls of a stopped ``torch.profiler``
    trace by the innermost program span of ``rec_spans`` (a recording's
    :meth:`spans`); ``below_sweep_s`` is the idle time inside a span
    below a sweep, ``idle_s`` all of it. The device is CUDA unless
    ``device_type`` names another (a test on the CPU)."""
    from torch.autograd import DeviceType

    device_type = DeviceType.CUDA if device_type is None else device_type
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = to_trace_us(rec_spans, start_ns)
    starts, paths = segments(spans)
    events = prof.events()
    idle: Dict[str, float] = defaultdict(float)
    below = total = 0.0
    for a, b in device_gaps(events, device_type):
        path = path_at(starts, paths, 0.5 * (a + b))
        name = path.rsplit("/", 1)[-1] if path else "other"
        idle[name] += (b - a) * 1e-6
        total += (b - a) * 1e-6
        if path and f"{SWEEP}/" in path:
            below += (b - a) * 1e-6
    calls: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name in runtime_calls:
            tr = e.time_range
            path = path_at(starts, paths, 0.5 * (tr.start + tr.end))
            calls[path.rsplit("/", 1)[-1] if path else "other"] += 1
    return dict(idle_s=total, below_sweep_s=below,
                idle_by_span=dict(sorted(idle.items(), key=lambda k: -k[1])),
                launches_by_span=dict(sorted(calls.items(),
                                             key=lambda k: -k[1])))


def _ms(spans: dict, name: str, per: float) -> Optional[float]:
    if name not in spans or not per:
        return None
    return 1e3 * spans[name]["total_s"] / per


def readings(summary: dict) -> Dict[str, Optional[float]]:
    """The engine's per-layer numbers from a recording's summary over
    whole search calls; ``None`` where the summary has no such span."""
    spans, counters = summary["spans"], summary["counters"]
    calls = summary["calls"]
    sweeps = spans.get(SWEEP, {}).get("count", 0)
    rounds = counters.get("exchange_rounds", 0)
    facade = None
    if "pf.search" in spans and "pf.engine" in spans and calls:
        facade = 1e3 * (spans["pf.search"]["total_s"]
                        - spans["pf.engine"]["total_s"]) / calls
    return dict(
        facade_span_ms=facade,
        sweep_span_ms=_ms(spans, SWEEP, sweeps),
        evaluate_ms_per_sweep=_ms(spans, "pf.evaluate", sweeps),
        propose_ms_per_sweep=_ms(spans, "pf.propose", sweeps),
        exchange_ms_per_round=_ms(spans, "pf.exchange", rounds),
        archive_copy_ms_per_sweep=_ms(spans, "pf.archive.copy", sweeps),
        archive_insert_ms_per_sweep=_ms(spans, "pf.archive.insert", sweeps),
        sync_wait_ms_per_sweep=_ms(spans, "pf.sync", sweeps),
        host_syncs_per_sweep=(counters.get("host_syncs", 0) / sweeps
                              if sweeps else None),
        d2h_bytes_per_call=(counters.get("d2h_bytes", 0) / calls
                            if calls else None))
