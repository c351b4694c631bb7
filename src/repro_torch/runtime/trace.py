"""Spans and counters of the port's host code: where a search's time
goes, and what it reads back from the device.

The tempering engine is paced by the host, which issues thousands of
kernel launches a sweep, so its spans time the host: each records
``time.perf_counter_ns()`` at both ends and never synchronizes. A
blocking read from the device is a span of its own, ``pf.sync``, so the
time the host waits for the device shows where it is spent.

Recording a run
---------------
Tracing is off until a recording is opened. Open one around the work to
look at, a search::

    from repro_torch.runtime import trace

    with trace.recording() as rec:
        pf.search(ParallelTempering(n_chains=512, sweeps=100), key=7)
    s = rec.summary()

or a service tick (``with trace.recording() as rec: service.step()``).
One recording is open at a time; spans of every thread go into it.
``rec.summary()`` holds:

- ``calls``: how many root spans ran (a root is a span opened with no
  span open on its thread; ``pf.search`` is the usual one). Every span
  carries the ``call_id`` of its root.
- ``spans``: by name, ``count``, ``total_s`` and ``self_s`` (the span's
  duration less the part its child spans cover).
- ``counters``: each counter's increase during the recording, summed
  over its sites, and ``sites``: the same by site.
- ``launches``: the hand-written kernels' launches during the
  recording, by kernel module (each module's own ``launch_count()``).

``rec.spans()`` gives the raw records ``(name, start_ns, end_ns, parent,
call_id)`` (``parent`` the index of the enclosing record, -1 for a root)
and the recording's ``anchor``: one ``(perf_counter_ns, time_ns)`` pair
read together, which puts the spans on the epoch clock of a profiler's
trace.

The spans of the tempering engine (``pathfinding/device.py``), each
around the function or block named:

=================  ====================================================
``pf.search``      ``Pathfinder.search`` (the root)
``pf.seed``        the seed population: drawn, seeded and encoded
``pf.engine``      either engine's ``parallel_tempering``
``pf.sweep``       one sweep of either engine's segment loop
``pf.propose``     ``_propose`` (its ``pf.validity``: ``_validity``)
``pf.evaluate``    ``_eval_cost`` > ``pf.metrics`` > ``pf.slots`` (>
                   ``pf.assign``), ``pf.gather``, ``pf.topology``
``pf.accept``      Metropolis acceptance, the best design, the draws
``pf.exchange``    ``_exchange``, one replica-exchange round
``pf.archive.*``   ``copy``: the samples' copy to the host at a
                   segment's end; ``insert``: ``ParetoArchive.insert``
``pf.result``      the engine's result, copied to the host
``pf.best``        the winner's decode and scalar evaluation
``pf.sync``        one blocking read (see :func:`fetch`, :func:`synced`)
=================  ====================================================

Counters are always on, plain integer adds like the kernels' launch
counts: ``host_syncs`` (blocking transfers, each of which waits for the
device to finish its queue) and ``d2h_bytes`` (bytes read back), both by
site, and ``exchange_rounds``. :func:`counts` reads them.

This module imports nothing of the port but its kernel modules, and
those only when a recording reads their launch counts.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

# the hand-written kernels' modules whose ``launch_count()`` a recording
# reads
KERNEL_MODULES = ("prefix_gather", "rglru", "systolic_gemm", "topology",
                  "wkv6")

_rec: Optional["Recording"] = None       # the open recording, if any
_counts: Dict[Tuple[str, str], int] = {}
_counts_lock = threading.Lock()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call_id: int


class _Off:
    """The shared span of a closed tracer: enters and exits, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "idx")

    def __init__(self, rec: "Recording", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.idx = self.rec._open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec._close(self.idx)
        return False


def span(name: str):
    """A context manager timing its block as span ``name`` while a
    recording is open; otherwise the shared no-op span."""
    rec = _rec
    if rec is None:
        return _OFF
    return _On(rec, name)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is span ``name`` while a
    recording is open."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _rec
            if rec is None:
                return fn(*args, **kwargs)
            with _On(rec, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1, site: str = "") -> None:
    """Add ``n`` to counter ``name`` at ``site``."""
    key = (name, site)
    with _counts_lock:
        _counts[key] = _counts.get(key, 0) + n


def counts() -> Dict[Tuple[str, str], int]:
    """Every counter by ``(name, site)``, since the process started."""
    with _counts_lock:
        return dict(_counts)


def synced(site: str, n: int = 1, nbytes: int = 0):
    """Count ``n`` blocking transfers (and ``nbytes`` read back) at
    ``site``, and time the block that makes them as ``pf.sync``. For a
    transfer that the code does not spell out as a copy: an upload of
    host data, an index by a device scalar."""
    count("host_syncs", n, site)
    if nbytes:
        count("d2h_bytes", nbytes, site)
    return span("pf.sync")


def fetch(t, site: str):
    """``t.cpu()``, counted as one blocking read of its bytes at
    ``site`` and timed as ``pf.sync``."""
    with synced(site, 1, t.numel() * t.element_size()):
        return t.cpu()


def _launches() -> Dict[str, int]:
    return {m: importlib.import_module(
        f"repro_torch.kernels.{m}.ops").launch_count()
        for m in KERNEL_MODULES}


class Recording:
    """The spans of one open recording, and the counters' and launch
    counts' values when it opened and closed."""

    def __init__(self):
        pc0 = time.perf_counter_ns()
        wall = time.time_ns()
        pc1 = time.perf_counter_ns()
        self.anchor = ((pc0 + pc1) // 2, wall)
        self._records: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._calls = 0
        self._at_open = (counts(), _launches())
        self._at_close: Optional[tuple] = None

    def _open(self, name: str) -> int:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            if stack:
                parent = stack[-1]
                call = self._records[parent][4]
            else:
                parent, call = -1, self._calls
                self._calls += 1
            idx = len(self._records)
            self._records.append([name, 0, 0, parent, call])
        stack.append(idx)
        self._records[idx][1] = time.perf_counter_ns()
        return idx

    def _close(self, idx: int) -> None:
        self._records[idx][2] = time.perf_counter_ns()
        self._local.stack.pop()

    def _close_recording(self) -> None:
        self._at_close = (counts(), _launches())

    def spans(self) -> Dict[str, object]:
        """The spans' records in the order they opened (``end_ns`` 0 for
        a span still open), and the anchor."""
        return dict(anchor=self.anchor,
                    spans=[Span(*r) for r in self._records])

    def summary(self) -> Dict[str, object]:
        """Spans by name, the counters' and launch counts' increase;
        see the module docstring."""
        recs = self._records
        child_ns = [0] * len(recs)
        for r in recs:
            if r[2] and r[3] >= 0:
                child_ns[r[3]] += r[2] - r[1]
        spans: Dict[str, Dict[str, float]] = {}
        for i, r in enumerate(recs):
            if not r[2]:
                continue
            s = spans.setdefault(r[0], dict(count=0, total_s=0.0,
                                            self_s=0.0))
            s["count"] += 1
            s["total_s"] += (r[2] - r[1]) * 1e-9
            s["self_s"] += (r[2] - r[1] - child_ns[i]) * 1e-9
        (c0, l0), (c1, l1) = self._at_open, (
            self._at_close or (counts(), _launches()))
        counters: Dict[str, int] = {}
        sites: Dict[str, Dict[str, int]] = {}
        for (name, site), v in sorted(c1.items()):
            d = v - c0.get((name, site), 0)
            if d:
                counters[name] = counters.get(name, 0) + d
                sites.setdefault(name, {})[site] = d
        return dict(calls=self._calls, spans=spans, counters=counters,
                    sites=sites,
                    launches={m: l1[m] - l0[m] for m in KERNEL_MODULES})


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn tracing on for the block; yields its :class:`Recording`."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a trace recording is already open")
    rec = Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec._close_recording()
