"""The port's tracer (``repro_torch.runtime.trace``): off by default,
spans nest with the right self time and call id, and a tempering search
records the spans and counters of its sweeps without moving a bit of
its result."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import workload
from repro_torch.core.techdb import DEFAULT_DB
from repro_torch.pathfinding import (
    DesignSpace,
    ParallelTempering,
    Pathfinder,
    ScalarizationSweep,
    ScenarioSweep,
)
from repro_torch.pathfinding import device as dev_mod
from repro_torch.runtime import trace

N_CHAINS, SWEEPS, SWAP_EVERY = 64, 12, 5


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter_ns`` as a clock that moves 10 ns a read."""
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))


def test_off_records_nothing():
    assert trace.span("a") is trace.span("b")         # the shared no-op

    @trace.spanned("f")
    def f(x):
        return x + 1

    before = trace.counts().get(("host_syncs", "t"), 0)
    with trace.span("a"):
        assert f(1) == 2
        with trace.synced("t", 2):
            pass
    # counters are always on
    assert trace.counts()[("host_syncs", "t")] == before + 2
    with trace.recording() as rec:
        pass
    with trace.span("after"):
        f(2)
    assert rec.spans()["spans"] == []
    assert rec.summary()["spans"] == {} and rec.summary()["calls"] == 0


def test_nesting_self_time_and_call_id(clock):
    @trace.spanned("b")
    def b():
        pass

    with trace.recording() as rec:            # the anchor reads 0 and 10
        with trace.span("a"):                 # 20 .. 70
            b()                               # 30 .. 40
            b()                               # 50 .. 60
        with trace.span("a"):                 # 80 .. 90
            pass
    recs = rec.spans()["spans"]
    assert [(s.name, s.start_ns, s.end_ns, s.parent, s.call_id)
            for s in recs] == [("a", 20, 70, -1, 0), ("b", 30, 40, 0, 0),
                               ("b", 50, 60, 0, 0), ("a", 80, 90, -1, 1)]
    assert rec.spans()["anchor"][0] == 5
    s = rec.summary()
    assert s["calls"] == 2
    assert s["spans"]["a"]["count"] == 2
    assert s["spans"]["a"]["total_s"] == pytest.approx(60e-9)
    assert s["spans"]["a"]["self_s"] == pytest.approx(40e-9)
    assert s["spans"]["b"]["self_s"] == pytest.approx(20e-9)


def test_another_threads_span_is_a_call_of_its_own():
    with trace.recording() as rec:
        with trace.span("main"):
            t = threading.Thread(target=lambda: trace.span("worker")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with trace.span("child"):
                pass
    by_name = {s.name: s for s in rec.spans()["spans"]}
    assert by_name["worker"].parent == -1
    assert by_name["child"].parent == 0
    assert by_name["worker"].call_id != by_name["main"].call_id
    assert rec.summary()["calls"] == 2


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    with trace.recording():                   # the first one closed
        pass


def test_fetch_counts_its_bytes():
    t = torch.zeros(3, 5, dtype=torch.float64)
    with trace.recording() as rec:
        out = trace.fetch(t, "here")
    assert torch.equal(out, t)
    s = rec.summary()
    assert s["sites"]["host_syncs"] == {"here": 1}
    assert s["sites"]["d2h_bytes"] == {"here": 3 * 5 * 8}
    assert s["spans"]["pf.sync"]["count"] == 1
    assert set(s["launches"]) == set(trace.KERNEL_MODULES)


def test_off_span_cost_is_reported(capsys):
    """What an off span costs on this CPU: reported, not held to a
    limit (timings of a shared machine are no test)."""
    n = 100_000

    @trace.spanned("f")
    def f():
        pass

    def per_call(body):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter_ns()
            body()
            best = min(best, (time.perf_counter_ns() - t) / n)
        return best

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with trace.span("x"):
                pass

    def plain():
        for _ in range(n):
            f.__wrapped__()

    def decorated():
        for _ in range(n):
            f()

    base = per_call(empty)
    ctx = per_call(spans) - base
    deco = per_call(decorated) - per_call(plain)
    with capsys.disabled():
        print(f"\noff span: {ctx:.0f} ns as a with block, {deco:.0f} ns "
              "as a decorated call (least of 5 runs)")
    assert ctx > 0 and deco > 0


SPACES = {
    "carbonpath-wl1-t1": (1, "legacy", "fixed"),
    "carbonpath-wl6-noc-window": (6, "mesh_noc", "window"),
}


@pytest.fixture(scope="module", params=sorted(SPACES))
def finder(request):
    wl, comm, schedule = SPACES[request.param]
    space = DesignSpace(DEFAULT_DB, 6, comm=comm, schedule=schedule)
    pf = Pathfinder(workload(wl), "T1", space=space, torch_device="cpu")
    pf.fit_normalizer(2000, 1234)
    return pf


def _search(pf, monkeypatch):
    """One 64-chain, 12-sweep tempering search; its result, the engine's
    result and the number of ``_eval_cost`` calls."""
    engine, evals = [], [0]
    real_pt, real_eval = (dev_mod.DeviceEvaluator.parallel_tempering,
                          dev_mod._eval_cost)

    def pt(self, *args, **kwargs):
        engine.append(real_pt(self, *args, **kwargs))
        return engine[-1]

    def eval_cost(*args, **kwargs):
        evals[0] += 1
        return real_eval(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(dev_mod.DeviceEvaluator, "parallel_tempering", pt)
        m.setattr(dev_mod, "_eval_cost", eval_cost)
        res = pf.search(ParallelTempering(
            n_chains=N_CHAINS, sweeps=SWEEPS, swap_every=SWAP_EVERY,
            frontier_size=256), key=2 ** 31 + 7)
    return res, engine[0], evals[0]


def test_search_spans_and_counters(finder, monkeypatch):
    with trace.recording() as rec:
        _, _, evals = _search(finder, monkeypatch)
    s = rec.summary()
    spans, sites = s["spans"], s["sites"]
    assert s["calls"] == 1
    assert spans["pf.search"]["count"] == spans["pf.engine"]["count"] == 1
    assert spans["pf.sweep"]["count"] == SWEEPS
    assert evals == SWEEPS + 1
    assert spans["pf.evaluate"]["count"] == evals
    assert spans["pf.propose"]["count"] == SWEEPS
    rounds = len(range(0, SWEEPS, SWAP_EVERY))
    assert spans["pf.exchange"]["count"] == rounds == 3
    assert s["counters"]["exchange_rounds"] == rounds
    for name in ("pf.seed", "pf.accept", "pf.metrics", "pf.slots",
                 "pf.assign", "pf.gather", "pf.topology", "pf.validity",
                 "pf.archive.copy", "pf.archive.insert", "pf.result",
                 "pf.best", "pf.sync"):
        assert spans[name]["count"] >= 1, name

    recs = rec.spans()["spans"]
    parent = [recs[r.parent].name if r.parent >= 0 else None for r in recs]
    assert {r.call_id for r in recs} == {0}
    assert recs[0].name == "pf.search" and recs[0].parent == -1
    assert {p for r, p in zip(recs, parent) if r.name == "pf.propose"} == {
        "pf.sweep"}
    ev = [p for r, p in zip(recs, parent) if r.name == "pf.evaluate"]
    assert ev == ["pf.engine"] + ["pf.sweep"] * SWEEPS   # the seed first
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns

    # one blocking read a check, before its device branch, as on the card;
    # two uploads an evaluation by the plain topology, which only the CPU
    # runs (test_card_search_launches_topology_without_uploads)
    width = finder.space.width
    rows = (SWEEPS + 1) * N_CHAINS
    assert sites["host_syncs"] == {
        "check": evals, "pairs": 2 * evals, "best": 2 + 3 * SWEEPS,
        "archive": 2, "result": 5, "upload": 11}
    assert sites["d2h_bytes"] == {
        "check": evals,
        "best": (2 + 3 * SWEEPS) * 8,
        "archive": rows * (width * 4 + 3 * 8),
        "result": (width * 4 + 8 + (SWEEPS + 1) * 8
                   + N_CHAINS * (width * 4 + 8))}


@pytest.mark.cuda
def test_card_search_launches_topology_without_uploads(monkeypatch):
    """On the card the topology stage is one kernel launch an evaluation
    and uploads nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pf = Pathfinder(workload(1), "T1", torch_device="cuda")
    pf.fit_normalizer(2000, 1234)
    with trace.recording() as rec:
        _search(pf, monkeypatch)
    s = rec.summary()
    assert "pairs" not in s["sites"]["host_syncs"]
    assert s["launches"]["topology"] == s["spans"]["pf.evaluate"]["count"]
    assert s["spans"]["pf.evaluate"]["count"] == SWEEPS + 1


def test_search_is_bit_identical_traced(finder, monkeypatch):
    off, off_engine, _ = _search(finder, monkeypatch)
    with trace.recording():
        on, on_engine, _ = _search(finder, monkeypatch)
    space = finder.space
    assert np.array_equal(space.encode(on.best), space.encode(off.best))
    assert on.best_cost == off.best_cost
    assert on.history == off.history
    assert on.evaluations == off.evaluations
    assert np.array_equal(on_engine.final_enc, off_engine.final_enc)
    assert np.array_equal(on_engine.final_costs, off_engine.final_costs)
    assert np.array_equal(on.frontier.encoded, off.frontier.encoded)
    assert np.array_equal(on.frontier.vectors, off.frontier.vectors)


def test_scenario_engine_spans_and_bits():
    sweep = ScenarioSweep(strategy=ScalarizationSweep(
        directions=2, n_chains=2, sweeps=3), norm_samples=100)

    def run():
        return sweep.run([workload(1), workload(6)], key=11,
                         torch_device="cpu")

    off = run()
    with trace.recording() as rec:
        on = run()
    s = rec.summary()
    assert s["spans"]["pf.engine"]["count"] == 1
    assert s["spans"]["pf.sweep"]["count"] == 3
    assert s["spans"]["pf.evaluate"]["count"] >= 4     # the seed and 3
    assert s["spans"]["pf.archive.copy"]["count"] >= 1
    assert s["sites"]["host_syncs"]["check"] == s["spans"]["pf.evaluate"][
        "count"]
    for key, res in off.results.items():
        assert np.array_equal(on.results[key].frontier.encoded,
                              res.frontier.encoded)
        assert np.array_equal(on.results[key].frontier.vectors,
                              res.frontier.vectors)
