"""The join of the program's spans with a profiler's trace
(``bench/harness/program_trace.py``), on a call profiled on the CPU
whose one long gap lies in a known span, and the readings of a
recording's summary."""
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from bench.harness import program_trace
from repro_torch.runtime import trace

GAP_S = 0.02


def _work():
    x = torch.ones(64, 64)
    for _ in range(3):
        x = x * 1.0001
    return x


def _call():
    """A call whose sweep spends ``GAP_S`` idle inside ``pf.evaluate``,
    between two runs of CPU operations (the stand-in device's)."""
    with trace.span("pf.search"), trace.span("pf.engine"):
        with trace.span("pf.sweep"):
            with trace.span("pf.propose"):
                _work()
            with trace.span("pf.evaluate"):
                _work()
                time.sleep(GAP_S)
                _work()
            with trace.span("pf.accept"):
                _work()


def test_join_puts_a_known_gap_in_its_span():
    with profile(activities=[ProfilerActivity.CPU]):
        pass                                  # the profiler's first start
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(2):                # the first range's entry is
                with record_function(f"bench.call{i}"):   # slow
                    _call()
    out = program_trace.join(prof, rec.spans(), device_type=DeviceType.CPU,
                             runtime_calls=("aten::mul",))
    idle = out["idle_by_span"]
    assert max(idle, key=idle.get) == "pf.evaluate"
    assert 2 * GAP_S <= idle["pf.evaluate"] < 2 * GAP_S + 0.05
    assert 2 * GAP_S <= out["below_sweep_s"] <= out["idle_s"]
    # three multiplications a _work(): one run in propose and accept, two
    # in evaluate, in each call
    assert out["launches_by_span"] == {"pf.evaluate": 12, "pf.propose": 6,
                                       "pf.accept": 6}
    # the second root span opens just inside the range around it: the
    # spans and the trace share one clock (within a bound that a loaded
    # machine's scheduling keeps to; a wrong epoch is off by far more)
    spans = program_trace.to_trace_us(
        rec.spans(), prof.profiler.kineto_results.trace_start_ns())
    roots = [s for s in spans if s[3] < 0]
    call = next(e for e in prof.events() if e.name == "bench.call1")
    assert 0 <= roots[1][0] - call.time_range.start < 5000
    assert 0 <= call.time_range.end - roots[1][1] < 5000


def test_segments_follow_the_innermost_span():
    spans = [(0.0, 10.0, "a", -1), (2.0, 4.0, "b", 0), (5.0, 6.0, "c", 0),
             (12.0, 13.0, "d", -1)]
    starts, paths = program_trace.segments(spans)
    at = [program_trace.path_at(starts, paths, t)
          for t in (-1.0, 1.0, 3.0, 4.5, 5.5, 8.0, 11.0, 12.5, 14.0)]
    assert at == [None, "a", "a/b", "a", "a/c", "a", None, "d", None]


def test_readings_of_a_summary():
    s = dict(calls=2, spans={
        "pf.search": dict(count=2, total_s=2.0, self_s=0.1),
        "pf.engine": dict(count=2, total_s=1.8, self_s=0.1),
        "pf.sweep": dict(count=20, total_s=1.5, self_s=0.0),
        "pf.evaluate": dict(count=22, total_s=1.0, self_s=0.0),
        "pf.exchange": dict(count=4, total_s=0.2, self_s=0.2),
        "pf.sync": dict(count=50, total_s=0.01, self_s=0.01)},
        counters=dict(host_syncs=120, d2h_bytes=1000, exchange_rounds=4))
    r = program_trace.readings(s)
    assert r["facade_span_ms"] == pytest.approx(100.0)
    assert r["sweep_span_ms"] == pytest.approx(75.0)
    assert r["evaluate_ms_per_sweep"] == pytest.approx(50.0)
    assert r["exchange_ms_per_round"] == pytest.approx(50.0)
    assert r["sync_wait_ms_per_sweep"] == pytest.approx(0.5)
    assert r["host_syncs_per_sweep"] == 6.0
    assert r["d2h_bytes_per_call"] == 500.0
    assert r["propose_ms_per_sweep"] is None
    assert r["archive_copy_ms_per_sweep"] is None


def test_program_spans_runs_on_the_cpu():
    """``bench/program_spans.py`` end to end at its CPU size: its line
    holds the engine's readings from the recorded calls."""
    import json
    import subprocess
    import sys

    from bench.harness.cell import ROOT
    from cpu_run import subprocess_env

    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "program_spans.py"),
         "--workload", "pt-wl1-default", "--seed", str(2 ** 31 + 9),
         "--calls", "1", "--device", "cpu"],
        capture_output=True, text=True, env=subprocess_env(), timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    read = line["readings"]
    assert set(read) == {
        "facade_span_ms", "sweep_span_ms", "evaluate_ms_per_sweep",
        "propose_ms_per_sweep", "exchange_ms_per_round",
        "archive_copy_ms_per_sweep", "archive_insert_ms_per_sweep",
        "sync_wait_ms_per_sweep", "host_syncs_per_sweep",
        "d2h_bytes_per_call"}
    assert all(v is not None and v > 0 for v in read.values())
    assert line["split"]["pf.sweep"]["count"] == 12
    assert line["clock"]["root"] == "pf.search"
    assert "split of the recorded calls" in out.stderr
