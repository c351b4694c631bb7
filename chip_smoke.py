#!/usr/bin/env python3
"""On-card smoke test of the torch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package. Phases, each printing
one JSON line that carries the card's name and power limit:

1. ``build``    — compile every CUDA kernel of the main path from the
   sources in the checkout (``nvcc``, sm_90a).
2. ``kernel``   — ``prefix_select`` on the card against its plain torch
   version on the card, bitwise (``torch.equal``), on the real int64
   tables of workload 1 (single layout) and workloads 1+6 (stacked
   layout), at P = 256, 512, 1024 and 4096 sampled systems plus edge
   rows; kernel and plain times by CUDA events (per call, in a CUDA
   graph and eager), and the bound.
3. ``evaluate`` — ``DeviceEvaluator(workload(1))`` on 4096 systems on
   cuda against the same calls on the CPU: tile assignment and reduction
   destinations equal, float outputs within 1e-6 relative.
4. ``golden``   — replays ``tests/goldens/device_pt_wl1_t1.json`` on the
   card (rtol 1e-6).
5. ``search``   — the main path: ``Pathfinder(workload(1), "T1")
   .search(ParallelTempering(n_chains=512, sweeps=100), key=0)`` with
   the default normalizer fit, timed, with the kernel launch counts of
   that run; the best design is re-evaluated on the card and on the CPU.

Then a line with the card (``nvidia-smi``), the ``kernels`` JSON line and,
last, ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero without that last line. Without CUDA, or outside a
checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor-core rate (data sheet)
TOL = 1e-6
DEV = "cuda"                   # the card the phases run on


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Per-call device time of ``iters`` calls captured in one CUDA graph
    and replayed: the host's issue time drops out, leaving the kernels'
    own run plus the gaps between them."""
    if DEV != "cuda":
        return cuda_ms(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return cuda_ms(g.replay, iters=5, warmup=2) / iters


# ---------------------------------------------------------------------------
# kernel phase: prefix_select against its plain version
# ---------------------------------------------------------------------------


def _padded(pref, bucket: int):
    """Edge-pad a ``[F, R, T+1]`` table's tile axis to ``bucket + 1``."""
    pad = bucket + 1 - pref.shape[-1]
    return torch.cat([pref, pref[..., -1:].expand(*pref.shape[:-1], pad)],
                     dim=-1)


def _bucket(t: int) -> int:
    return max(64, 1 << (int(t) - 1).bit_length())


def kernel_inputs(layout: str, P: int, seed: int, dev):
    """Tables, indices and bounds for one prefix_select call, from
    systems drawn by DesignSpace.sample and assigned by Algorithm 1,
    with edge rows appended (ranges outside [0, T], empty ranges, both
    split values)."""
    from repro_torch.core import workload
    from repro_torch.pathfinding.device import DeviceEvaluator, _slots
    from repro_torch.pathfinding.space import COL_DATAFLOW, COL_SPLITK

    wls = [workload(1)] if layout == "single" else [workload(1),
                                                    workload(6)]
    evs = [DeviceEvaluator(wl, torch_device=dev) for wl in wls]
    cfg = evs[0].cfg
    if layout == "single":
        p0, p1 = evs[0].tables["pref0_flat"], evs[0].tables["pref1_flat"]
    else:
        # the workload-stacked layout: each workload's tables edge-padded
        # to a shared tile bucket, concatenated along rows
        b0 = _bucket(max(e.cfg.T0 for e in evs))
        b1 = _bucket(max(e.cfg.T1 for e in evs))
        p0 = torch.cat([_padded(e.tables["pref0_flat"], b0) for e in evs], 1)
        p1 = torch.cat([_padded(e.tables["pref1_flat"], b1) for e in evs], 1)
    rng = np.random.default_rng(seed)
    enc = evs[0].space.sample(P, key=int(rng.integers(1 << 30)))
    wi = (np.zeros(P, np.int64) if layout == "single"
          else rng.integers(0, len(wls), P))
    starts, ends = [], []
    for k, ev in enumerate(evs):
        st = _slots(ev._enc(enc), ev.tables, ev.cfg)
        starts.append(st["start"].cpu().numpy())
        ends.append(st["end"].cpu().numpy())
        if k == 0:
            a = st["a_idx"].cpu().numpy()
            s = st["s_idx"].cpu().numpy()
    start = np.choose(wi[:, None], starts)
    end = np.choose(wi[:, None], ends)
    rows = ((a * cfg.S + s) * 3 + enc[:, COL_DATAFLOW][:, None]
            + wi[:, None] * cfg.A * cfg.S * 3)
    split = enc[:, COL_SPLITK].astype(np.int64)
    t0 = np.array([evs[w].cfg.T0 for w in wi])
    t1 = np.array([evs[w].cfg.T1 for w in wi])
    # edge rows: out-of-range starts/ends, empty ranges, both splits
    m = min(64, P // 4)
    C = rows.shape[1]
    start[:m] = rng.integers(-8, t1[:m, None] + 16, (m, C))
    end[:m] = rng.integers(-8, t1[:m, None] + 16, (m, C))
    end[:m // 2, ::2] = start[:m // 2, ::2]
    split[:m] = np.arange(m) % 2

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=dev)

    i32 = torch.int32
    return (p0.contiguous(), p1.contiguous(), t(rows, i32),
            t(start, i32), t(end, i32), t(split, i32), t(t0, i32),
            t(t1, i32))


def kernel_bound(args) -> dict:
    """Least time for the work: the distinct table entries this run's
    inputs touch, the indices read once, the outputs written once, over
    HBM bandwidth; against one subtract + one add per output over the
    non-tensor-core rate."""
    p0, p1, rows, start, end, split, t0, t1 = args
    F, R = p0.shape[:2]
    P, C = rows.shape
    sp = (split == 1)[:, None]
    t = torch.where(sp, t1[:, None], t0[:, None]).long()
    s = torch.minimum(start.long().clamp(min=0), t)
    e = torch.minimum(end.long().clamp(min=0), t)
    which = sp.long().expand(P, C)
    ids = []
    for idx in (s, e):
        flat = (which * R + rows.long()) * 4096 + idx  # T_b + 1 <= 4096
        ids.append(flat.reshape(-1))
    if max(p0.shape[2], p1.shape[2]) > 4096:
        raise ValueError("tile axis longer than the id packing allows")
    n_entries = int(torch.unique(torch.cat(ids)).numel()) * F
    nbytes = (n_entries * 8 + (3 * P * C + 3 * P) * 4
              + (P * C * F + P * F) * 8)
    ops = 2 * P * C * F
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def phase_kernel(card: str) -> dict:
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.prefix_gather import prefix_select_plain

    lib = kops.build()
    main = None
    worst = 0
    for layout in ("single", "stacked"):
        for P in (256, 512, 1024, 4096):
            args = kernel_inputs(layout, P, seed=P, dev=DEV)
            sel_k, tot_k = kops.prefix_select(*args)
            sel_p, tot_p = prefix_select_plain(*args)
            torch.cuda.synchronize()
            equal = torch.equal(sel_k, sel_p) and torch.equal(tot_k, tot_p)
            err = int(max((sel_k - sel_p).abs().max(),
                          (tot_k - tot_p).abs().max()))
            worst = max(worst, err)
            if not equal:
                raise AssertionError(
                    f"prefix_select != plain ({layout}, P={P}): max abs "
                    f"err {err}")
            p0, p1, rows, start, end, split, t0, t1 = args
            Pn, C = rows.shape
            F = p0.shape[0]
            sel = torch.empty((Pn, C, F), dtype=torch.int64, device=DEV)
            tot = torch.empty((Pn, F), dtype=torch.int64, device=DEV)
            def launch():
                # the current stream is read per call, so a CUDA-graph
                # capture records the launch on its capture stream
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.prefix_select_launch(
                    p0.data_ptr(), p1.data_ptr(), p0.shape[1], p0.shape[2],
                    p1.shape[2], F, rows.data_ptr(), start.data_ptr(),
                    end.data_ptr(), split.data_ptr(), t0.data_ptr(),
                    t1.data_ptr(), Pn, C, sel.data_ptr(), tot.data_ptr(),
                    stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            # ms: the device time per call, from a CUDA-graph replay;
            # eager_ms: back-to-back calls from Python, where host issue
            # can dominate a kernel this small
            plain = lambda: prefix_select_plain(*args)  # noqa: E731
            rec = dict(phase="kernel", kernel="prefix_select", layout=layout,
                       P=P, equal=equal, max_abs_err=err,
                       ms=graph_ms(launch), plain_ms=graph_ms(plain),
                       eager_ms=cuda_ms(launch), plain_eager_ms=cuda_ms(plain),
                       **kernel_bound(args), card=card)
            emit(rec)
            if layout == "single" and P == 512:
                main = rec
    main = dict(main, max_abs_err=worst)
    return main


# ---------------------------------------------------------------------------
# evaluate / golden / search phases
# ---------------------------------------------------------------------------


def _allclose(name, got, ref, rtol=TOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} vs {ref.shape} or "
                             "non-finite values")
    dev = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    dev = np.where(got == ref, 0.0, dev)
    worst = float(dev.max()) if dev.size else 0.0
    if worst > rtol:
        raise AssertionError(f"{name}: max rel deviation {worst} > {rtol}")
    return worst


def phase_evaluate(card: str) -> dict:
    from repro_torch.core import TEMPLATES, workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import (
        DeviceEvaluator,
        MetricsBatch,
        fit_normalizer_batched,
    )
    from repro_torch.pathfinding.device import _slots, _topology

    wl = workload(1)
    gpu = DeviceEvaluator(wl, torch_device=DEV)
    cpu = DeviceEvaluator(wl, torch_device="cpu")
    enc = gpu.space.sample(4096, key=11)
    norm = fit_normalizer_batched(wl, samples=400, seed=7,
                                  torch_device="cpu")
    tmpl = TEMPLATES["T1"]
    kops.reset_launch_count()
    t = time.perf_counter()
    mb_g, cost_g, vec_g = gpu.evaluate_cost_vector(enc, norm, tmpl)
    gpu_s = time.perf_counter() - t
    launches = kops.launch_count()
    if launches < 1:
        raise AssertionError("evaluate on cuda did not launch prefix_select")
    mb_c, cost_c, vec_c = cpu.evaluate_cost_vector(enc, norm, tmpl)
    met_g, met_c = gpu.metrics(enc), cpu.metrics(enc)
    worst = 0.0
    for f in MetricsBatch.__dataclass_fields__:
        worst = max(worst, _allclose(f, getattr(mb_g, f), getattr(mb_c, f)),
                    _allclose(f, getattr(met_g, f), getattr(met_c, f)))
    worst = max(worst, _allclose("cost", cost_g, cost_c),
                _allclose("vec", vec_g, vec_c))
    ints = {}
    for name, ev in (("gpu", gpu), ("cpu", cpu)):
        v = ev._enc(enc)
        st = _slots(v, ev.tables, ev.cfg)
        topo = _topology(v, st["areas"], ev.tables, ev.cfg)
        ints[name] = [x.cpu().numpy() for x in
                      (st["start"], st["end"], topo["dest"], topo["hops"])]
    for a, b, what in zip(ints["gpu"], ints["cpu"],
                          ("start", "end", "dest", "hops")):
        if not np.array_equal(a, b):
            raise AssertionError(f"integer output {what} differs cuda/cpu")
    torch.cuda.synchronize()
    rec = dict(phase="evaluate", P=len(enc), max_rel_dev=worst,
               ints_equal=True, kernel_launches=launches,
               gpu_eval_s=gpu_s, card=card)
    emit(rec)
    return rec


def phase_golden(card: str) -> dict:
    from repro_torch.core import TEMPLATES, workload
    from repro_torch.pathfinding import (
        DesignSpace,
        ParallelTempering,
        Pathfinder,
        fit_normalizer_batched,
    )

    with open(os.path.join(REPO, "tests", "goldens",
                           "device_pt_wl1_t1.json")) as f:
        golden = json.load(f)
    space = DesignSpace()
    wl = workload(1)
    norm = fit_normalizer_batched(wl, samples=400, seed=7, space=space,
                                  torch_device=DEV)
    pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space,
                    torch_device=DEV)
    t = time.perf_counter()
    res = pf.search(ParallelTempering(n_chains=4, sweeps=20), key=3)
    wall = time.perf_counter() - t
    if len(res.frontier) < 3:
        raise AssertionError(f"golden frontier too small: {len(res.frontier)}")
    got = {"history": res.history, "best_cost": res.best_cost,
           "evaluations": res.evaluations,
           "frontier_latency_min": float(res.frontier.vectors[:, 0].min()),
           "frontier_cfp_min": float(res.frontier.vectors[:, 2].min())}
    if got["evaluations"] != golden["evaluations"]:
        raise AssertionError("golden evaluations differ")
    worst = 0.0
    for k in ("history", "best_cost", "frontier_latency_min",
              "frontier_cfp_min"):
        worst = max(worst, _allclose(f"golden.{k}", np.asarray(got[k]),
                                     np.asarray(golden[k])))
    rec = dict(phase="golden", max_rel_dev=worst,
               frontier=len(res.frontier), wall_s=wall, card=card)
    emit(rec)
    return rec


def phase_search(card: str) -> dict:
    from repro_torch.core import workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import (
        DeviceEvaluator,
        ParallelTempering,
        Pathfinder,
    )

    n_chains, sweeps = 512, 100
    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    norm = pf.norm                       # default fit: 2000 samples
    fit_s = time.perf_counter() - t
    strat = ParallelTempering(n_chains=n_chains, sweeps=sweeps)
    kops.reset_launch_count()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pf.search(strat, key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"prefix_select": kops.launch_count()}
    if launches["prefix_select"] < 1:
        raise AssertionError("search did not launch prefix_select")
    if not (math.isfinite(res.best_cost) and len(res.history) == sweeps + 1
            and res.evaluations == n_chains * (sweeps + 1)
            and len(res.frontier) > 0):
        raise AssertionError(f"search output malformed: {res!r}")
    best = pf.space.encode(res.best)[None]
    costs = {}
    for dev in (DEV, "cpu"):
        ev = DeviceEvaluator(pf.wl, space=pf.space, torch_device=dev)
        costs[dev] = float(ev.evaluate_cost(best, norm, pf.template)[1][0])
    for dev, c in costs.items():
        if abs(c - res.best_cost) > TOL * abs(res.best_cost):
            raise AssertionError(
                f"best re-evaluated on {dev}: {c} != {res.best_cost}")
    vec = res.frontier.vectors
    if not np.all(np.isfinite(vec)):
        raise AssertionError("non-finite frontier vectors")
    rec = dict(phase="search", n_chains=n_chains, sweeps=sweeps,
               fit_s=fit_s, wall_s=wall, sweeps_per_s=sweeps / wall,
               evals_per_s=res.evaluations / wall, best_cost=res.best_cost,
               best_cost_cuda=costs[DEV], best_cost_cpu=costs["cpu"],
               frontier=len(res.frontier), launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit(rec)
    return rec


def phase_profile(card: str) -> dict:
    """Device busy share of a short steady search window, from
    torch.profiler (``null`` when the tracer reports no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import workload
    from repro_torch.pathfinding import ParallelTempering, Pathfinder

    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    pf.norm
    strat = ParallelTempering(n_chains=512, sweeps=5, frontier_size=0)
    pf.search(strat, key=1)                    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pf.search(strat, key=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only (their self time is the kernel's run)
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(float(getattr(e, "self_device_time_total", 0) or 0)
                 for e in kern)
    top = sorted(kern, key=lambda e: -float(
        getattr(e, "self_device_time_total", 0) or 0))[:8]
    rec = dict(phase="profile", n_chains=512, sweeps=5, wall_s=wall,
               device_busy_s=dev_us / 1e6 if dev_us else None,
               idle_share=(1 - dev_us / 1e6 / wall) if dev_us else None,
               device_kernels=sum(e.count for e in kern),
               top=[(e.key[:80], e.count,
                     float(getattr(e, "self_device_time_total", 0) or 0))
                    for e in top], card=card)
    emit(rec)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    from repro_torch.kernels.prefix_gather import ops as kops

    t = time.perf_counter()
    kops.build()
    log = kops.BUILD_DIR.glob("prefix_select_*.log")
    emit(dict(phase="build", kernels=["prefix_select"],
              seconds=time.perf_counter() - t,
              ptxas=[ln.strip() for p in log for ln in
                     p.read_text().splitlines() if "ptxas info" in ln],
              card=card))
    kmain = phase_kernel(card)
    phase_evaluate(card)
    phase_golden(card)
    search = phase_search(card)
    phase_profile(card)

    print(card)
    emit({"kernels": [{
        "name": "prefix_select", "route": "cuda",
        "source": "src/repro_torch/kernels/prefix_gather/csrc/"
                  "prefix_select.cu",
        "replaces": "src/repro/kernels/prefix_gather/kernel.py:79",
        "launches": search["launches"]["prefix_select"],
        "max_abs_err": kmain["max_abs_err"], "ms": kmain["ms"],
        "plain_ms": kmain["plain_ms"], "bound_ms": kmain["bound_ms"],
        "bound_by": kmain["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
