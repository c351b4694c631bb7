#!/usr/bin/env python
"""Serving proof on the torch port: kill-and-resume a whole pathfinding
service (the counterpart of ``scripts/serve_pathfinder.py``; it imports
only ``repro_torch``).

Two entry points:

``run``
    Start a :class:`~repro_torch.serving.PathfinderService` over a fixed
    2-workload catalog, submit six jobs spanning two bucket shapes (swap
    cadences 5 and 3 at four chains each), drain inline, and optionally
    write every job's history, best and frontier to an ``.npz``. With
    ``--checkpoint-root`` each job snapshots at every segment boundary
    and a rerun resumes all of them from their newest snapshots.
    ``--solo JOB_ID`` restricts the table to one job; ``--mode solo``
    runs each job in a fresh single-job service (the bit-identity
    reference). ``--max-segments N`` hard-exits the process (code 3)
    right after the N-th snapshot; ``--sleep S`` sleeps after each
    snapshot to widen the window for a real SIGTERM. ``--torch-device``
    names the device (default cuda). The last line of its output is a
    JSON object with the drain's wall time, its jobs and the process's
    ``prefix_select`` launches.

``check``
    The full lane: solo uninterrupted references for all six jobs, a
    live multiplexed service SIGTERMed mid-flight, a restarted service
    that resumes every job, and an assertion that each resumed job is
    bit-identical to its solo reference.

Usage::

    PYTHONPATH=src python scripts/torch_serve_pathfinder.py check
    PYTHONPATH=src python scripts/torch_serve_pathfinder.py run \\
        --torch-device cpu --out ref.npz
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from torch_resume_worker import launch_count, preempt_after

# the fixed job table: contention (6 jobs, 4 slots) and several
# boundaries per job
KEY = 5
SLOTS = 4
SEGMENT = 2
SWEEPS = 8
NORM_SAMPLES = 80
#          job id        workload  carbon    swap_every
JOBS = [("wl1-mid", 0, 0.475, 5),
        ("wl1-hydro", 0, 0.024, 5),
        ("wl6-coal", 1, 0.82, 5),
        ("wl6-mid", 1, 0.475, 3),
        ("wl1-coal", 0, 0.82, 3),
        ("wl6-hydro", 1, 0.024, 3)]


def workloads():
    from repro_torch.core import workload

    return [workload(1), workload(6)]


def job_spec(job_id: str, widx: int, ci: float, swap: int):
    from repro_torch.core.regions import Region
    from repro_torch.pathfinding import ScalarizationSweep
    from repro_torch.serving import JobSpec

    return JobSpec(
        job_id=job_id, workload=workloads()[widx].name,
        strategy=ScalarizationSweep(directions=2, n_chains=2,
                                    sweeps=SWEEPS, swap_every=swap),
        region=Region(carbon_intensity=ci))


def service(checkpoint_root=None, torch_device=None):
    from repro_torch.serving import PathfinderService

    return PathfinderService(
        workloads(), slots=SLOTS, segment=SEGMENT,
        norm_samples=NORM_SAMPLES, key=KEY,
        checkpoint_root=checkpoint_root, torch_device=torch_device)


def collect(svc, jobs, payload):
    """Each job's result arrays, keyed ``<field>_<job id>``."""
    for job_id, *_ in jobs:
        res = svc.result(job_id)
        payload[f"enc_{job_id}"] = res.frontier.encoded
        payload[f"vec_{job_id}"] = res.frontier.vectors
        payload[f"hist_{job_id}"] = np.asarray(res.history)
        payload[f"best_cost_{job_id}"] = np.float64(res.best_cost)
        payload[f"best_enc_{job_id}"] = res.best_enc
        payload[f"sweeps_{job_id}"] = np.int64(res.sweeps)


def serve_table(mode: str = "service", jobs=JOBS, checkpoint_root=None,
                torch_device=None) -> dict:
    """Run ``jobs`` multiplexed on one service (``"service"``) or each in
    a fresh single-job service (``"solo"``); returns their arrays."""
    payload = {}
    if mode == "solo":
        for job in jobs:
            svc = service(torch_device=torch_device)
            svc.submit(job_spec(*job))
            svc.drain()
            collect(svc, [job], payload)
    else:
        svc = service(checkpoint_root, torch_device)
        for job in jobs:
            svc.submit(job_spec(*job))
        svc.drain()
        collect(svc, jobs, payload)
    return payload


def cmd_run(args: argparse.Namespace) -> int:
    if args.max_segments or args.sleep:
        preempt_after(args.max_segments, args.sleep)
    jobs = JOBS
    if args.solo:
        jobs = [j for j in JOBS if j[0] == args.solo]
        if not jobs:
            raise SystemExit(f"unknown job {args.solo!r}")
    t = time.perf_counter()
    payload = serve_table(args.mode, jobs, args.checkpoint_root,
                          args.torch_device)
    wall = time.perf_counter() - t
    if args.out:
        np.savez(args.out, **payload)
    n_pts = sum(len(payload[f"enc_{j}"]) for j, *_ in jobs)
    print(f"service drained: {len(jobs)} jobs, {n_pts} frontier points")
    print(json.dumps(dict(wall_s=wall, jobs=len(jobs),
                          launches=launch_count())))
    return 0


def _finished_steps(root: str):
    """Completed snapshot dirs across all job subdirectories (torn
    ``step_N.tmp`` dirs count for nothing)."""
    return [d for d in glob.glob(os.path.join(root, "*", "step_*"))
            if not d.endswith(".tmp")
            and os.path.exists(os.path.join(d, "checkpoint.json"))]


def _wait_for_checkpoint(root: str, proc: subprocess.Popen,
                         timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return False  # finished (or died) before any snapshot
        if _finished_steps(root):
            return True
        time.sleep(0.05)
    return False


def cmd_check(args: argparse.Namespace) -> int:
    workdir = args.workdir or tempfile.mkdtemp(prefix="serve-smoke-")
    os.makedirs(workdir, exist_ok=True)
    me = os.path.abspath(__file__)
    dev = ["--torch-device", args.torch_device] if args.torch_device \
        else []

    def worker(*extra: str) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, me, "run", *dev, *extra])

    ref_npz = os.path.join(workdir, "reference.npz")
    res_npz = os.path.join(workdir, "resumed.npz")
    ckpt = os.path.join(workdir, "ckpt")

    print("[1/4] solo uninterrupted reference runs", flush=True)
    if worker("--mode", "solo", "--out", ref_npz).wait() != 0:
        raise RuntimeError("reference runs failed")

    print("[2/4] multiplexed service + SIGTERM mid-flight", flush=True)
    killed = False
    for attempt, sleep_s in enumerate((1.0, 3.0), 1):
        # a fresh root per attempt: stale snapshots of an attempt that
        # drained before its SIGTERM must not satisfy the wait
        shutil.rmtree(ckpt, ignore_errors=True)
        proc = worker("--checkpoint-root", ckpt, "--sleep", str(sleep_s))
        if _wait_for_checkpoint(ckpt, proc, timeout=args.timeout):
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
            print(f"    SIGTERM delivered (attempt {attempt}), "
                  f"service exit code {rc}", flush=True)
            if rc == 0:
                raise RuntimeError("service survived SIGTERM")
            killed = True
            break
        proc.wait()
        print(f"    attempt {attempt}: service drained before SIGTERM "
              "window; widening sleep", flush=True)
    if not killed:
        raise RuntimeError("could not interrupt the service mid-flight")
    steps = _finished_steps(ckpt)
    if not steps:
        raise RuntimeError("no checkpoint survived the kill")
    by_job = sorted({os.path.basename(os.path.dirname(s)) for s in steps})
    print(f"    jobs with snapshots on disk: {by_job}", flush=True)

    print("[3/4] restart service, resume all jobs", flush=True)
    if worker("--checkpoint-root", ckpt, "--out", res_npz).wait() != 0:
        raise RuntimeError("restarted service failed")

    print("[4/4] bit-identical comparison against solo references",
          flush=True)
    a, b = np.load(ref_npz), np.load(res_npz)
    if set(a.files) != set(b.files):
        print(f"MISMATCH in files: {a.files} vs {b.files}")
        return 1
    for k in sorted(a.files):
        if not np.array_equal(a[k], b[k]):
            print(f"MISMATCH in {k}:\nref={a[k]!r}\nres={b[k]!r}")
            return 1
    print(f"serving kill-and-resume OK: {len(JOBS)} jobs, "
          f"{len(a.files)} arrays bit-identical (workdir {workdir})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="one service process")
    chk = sub.add_parser("check", help="full serving kill-and-resume proof")
    for p in (run, chk):
        p.add_argument("--torch-device", default=None,
                       help="torch device (default: cuda)")
    run.add_argument("--mode", choices=("service", "solo"),
                     default="service")
    run.add_argument("--solo", default=None, metavar="JOB_ID",
                     help="restrict to one job from the table")
    run.add_argument("--checkpoint-root", default=None)
    run.add_argument("--out", default=None)
    run.add_argument("--max-segments", type=int, default=0)
    run.add_argument("--sleep", type=float, default=0.0)
    chk.add_argument("--workdir", default=None)
    chk.add_argument("--timeout", type=float, default=900.0,
                     help="max seconds to wait for the first checkpoint")
    args = ap.parse_args()
    return cmd_run(args) if args.cmd == "run" else cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
