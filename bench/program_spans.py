"""The program's own spans and counters over one cell's search calls, on
the card.

    python3 bench/program_spans.py --workload <cell> --seed <n> [--calls 3]

from the root of a checkout. After the cell's set-up (the kernel, the
normalizer, the warm call), it runs, in one process:

1. ``2 * calls`` calls in turns, without and with a recording of
   ``repro_torch.runtime.trace`` open, each timed from outside as the
   benchmark times ``sweep_ms`` (the engine's span less the archive's,
   to a synchronize, over the call's sweeps): what the recording costs;
2. from the recorded calls, the engine's per-layer readings
   (:func:`bench.harness.program_trace.readings`), the sweep's split by
   span, and ``pf.engine`` beside the outside engine span;
3. one call under ``torch.cuda.set_sync_debug_mode("warn")`` with a
   recording open: the program's ``host_syncs`` beside the syncs torch
   reports;
4. one call profiled over sweeps 5-9 as a traced benchmark run profiles
   it, with a recording open: the idle gaps and the host's launch calls
   by program span (:func:`bench.harness.program_trace.join`), beside the
   benchmark's own breakdown of the same trace;
5. one short call profiled whole inside a ``bench.call`` range: where
   ``pf.search`` starts on the trace's clock.

The last line of standard output is one JSON object; the tables go to
standard error. ``--device cpu`` rehearses steps 1, 2, 4 and 5 on the
CPU at 64 chains and 12 sweeps (no device, so no gaps and no syncs to
compare).
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_chains=64, sweeps=12)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    import torch

    from bench.harness import program_trace, spans
    from bench.harness.cell import (
        Program,
        load_cell,
        load_module,
        profiled,
        resolve,
        sync,
    )
    from repro_torch.runtime import trace

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    traffic = cell["traffic"]
    params = dict(traffic["strategy"]["params"],
                  **(TINY if device == "cpu" else {}))
    strat_spec = dict(traffic["strategy"], params=params)
    build = load_module("drivers", traffic["driver"]).build
    strategy = build(strat_spec)
    warm = build(dict(strat_spec, params=dict(params, **traffic.get(
        "warm", {}))))
    budget = traffic.get("budget")
    program = Program(cell, device)
    if device == "cuda":
        from repro_torch.kernels.prefix_gather import ops as kops

        kops.build()
    program.fit()
    keys = iter(range(args.seed * 1000, args.seed * 1000 + 1000))

    def call(strat=strategy):
        res = program.pf.search(strat, budget=budget, key=next(keys))
        sync(device)
        return res

    call(warm)

    # 1-2. turns without and with a recording, timed from outside
    engine = spans.Wrap(*resolve(traffic["spans"]["bench.engine"]),
                        device=device, timed=True)
    archive = spans.Wrap(*resolve(traffic["spans"]["bench.archive"]),
                         device=device, timed=True)
    sweep_ms = dict(off=[], on=[])
    summaries, engine_ratio = [], []
    with engine, archive:
        for i in range(2 * args.calls):
            on = i % 2 == 1
            e0, a0 = len(engine.seconds), len(archive.seconds)
            if on:
                with trace.recording() as rec:
                    res = call()
                s = rec.summary()
                summaries.append(s)
                engine_ratio.append(s["spans"]["pf.engine"]["total_s"]
                                    / sum(engine.seconds[e0:]))
            else:
                res = call()
            sweeps = len(res.history) - 1
            sweep_ms["on" if on else "off"].append(
                1e3 * (sum(engine.seconds[e0:]) - sum(archive.seconds[a0:]))
                / sweeps)
    total = merge(summaries)
    read = program_trace.readings(total)
    sweep = total["spans"]["pf.sweep"]
    # the sweep's direct children are propose, evaluate, accept and the
    # exchange: what they cover is what the sweep's self time leaves
    cover = 1.0 - sweep["self_s"] / sweep["total_s"]
    split = {k: dict(count=v["count"],
                     ms_per_sweep=round(1e3 * v["total_s"] / sweep["count"],
                                        4),
                     self_ms_per_sweep=round(1e3 * v["self_s"]
                                             / sweep["count"], 4))
             for k, v in sorted(total["spans"].items(),
                                key=lambda kv: -kv[1]["total_s"])}
    print("split of the recorded calls, ms a sweep (total, self):",
          file=sys.stderr)
    for k, v in split.items():
        print(f"  {k:20s} {v['ms_per_sweep']:10.4f} "
              f"{v['self_ms_per_sweep']:10.4f}  x{v['count']}",
              file=sys.stderr)

    # 3. the program's count of host syncs beside torch's
    syncs = None
    if device == "cuda":
        # torch syncs once the first time its debug mode is turned on
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with trace.recording() as rec:
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    program.pf.search(strategy, budget=budget,
                                      key=next(keys))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message))
        s = rec.summary()
        syncs = dict(program=s["counters"].get("host_syncs", 0),
                     torch=sum(sites.values()),
                     program_sites=s["sites"].get("host_syncs", {}),
                     torch_sites=dict(sites))

    # 4. the profiled sweeps, by program span
    spans.warm_profiler(device)
    window, pwraps = profiled(traffic, device)
    with trace.recording() as rec:
        for w in pwraps:
            w.__enter__()
        try:
            with spans.label("bench.call"):
                call()
        finally:
            for w in reversed(pwraps):
                w.__exit__(None, None, None)
            window.stop()
    joined = program_trace.join(window.prof, rec.spans())
    bench_trace = spans.read_trace(window)
    n = max(window.periods, 1)
    profiled_call = dict(
        periods=window.periods, window_s=bench_trace["window_s"],
        busy_s=bench_trace["busy_s"], idle_s=joined["idle_s"],
        below_sweep_share=(joined["below_sweep_s"] / joined["idle_s"]
                           if joined["idle_s"] else None),
        idle_ms_by_span_per_sweep={k: round(v / n * 1e3, 4) for k, v in
                                   joined["idle_by_span"].items()},
        launches_by_span_per_sweep={k: v / n for k, v in
                                    joined["launches_by_span"].items()},
        bench_idle_gaps=[list(k) for k in bench_trace["idle_gaps"]],
        kernels_per_sweep=bench_trace["n_device_ops"] / n)
    print("idle by span: " + json.dumps(
        profiled_call["idle_ms_by_span_per_sweep"]), file=sys.stderr)
    print("launches by span: " + json.dumps(
        profiled_call["launches_by_span_per_sweep"]), file=sys.stderr)

    # 5. where the root span starts on the trace's clock
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with trace.recording() as rec:
        with profile(activities=acts) as prof:
            with spans.label("bench.call"):
                call(warm)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    root = program_trace.to_trace_us(rec.spans(), start_ns)[0]
    rng = next(e for e in prof.events() if e.name == "bench.call"
               and e.device_type.name == "CPU")
    clock = dict(root=root[2], start_after_range_us=root[0]
                 - rng.time_range.start,
                 end_before_range_us=rng.time_range.end - root[1])

    line = dict(
        workload=args.workload, seed=args.seed, card=card_line()
        if device == "cuda" else device, torch=torch.__version__,
        calls=args.calls, sweep_ms=sweep_ms, readings=read,
        sweep_children_share=cover, engine_over_bench_engine=engine_ratio,
        counters=total["counters"], sites=total["sites"],
        launches=total["launches"], split=split, syncs=syncs,
        profiled=profiled_call, clock=clock)
    print(json.dumps(line))
    return 0


def merge(summaries) -> dict:
    """The summaries of several recordings as one."""
    out = dict(calls=0, spans={}, counters={}, sites={}, launches={})
    for s in summaries:
        out["calls"] += s["calls"]
        for k, v in s["spans"].items():
            t = out["spans"].setdefault(k, dict(count=0, total_s=0.0,
                                                self_s=0.0))
            for f in t:
                t[f] += v[f]
        for k, v in s["counters"].items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, by in s["sites"].items():
            d = out["sites"].setdefault(k, {})
            for site, v in by.items():
                d[site] = d.get(site, 0) + v
        for k, v in s["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    return out


if __name__ == "__main__":
    T0 = time.perf_counter()
    rc = main()
    print(f"program_spans: {time.perf_counter() - T0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
