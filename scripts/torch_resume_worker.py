#!/usr/bin/env python
"""Kill-and-resume proof for interruptible scenario sweeps on the torch
port (the counterpart of ``scripts/resume_worker.py``; it imports only
``repro_torch``).

Two entry points:

``run``
    Execute a fixed scenario sweep and optionally write its final
    per-cell frontiers, histories and best designs to an ``.npz``.
    ``--grid tiny`` (default) is the reference worker's sweep: 2 regions
    x workload 1, 2 directions x 2 chains, 8 sweeps in 2-sweep segments,
    key 5. ``--grid defaults`` is ``Pathfinder(workload(1), "T1")
    .run_scenarios(workloads=[workload(1), workload(6)], key=0)`` at its
    defaults (5 regions x 2 workloads, 8 directions x 4 chains, 40
    sweeps) in 10-sweep segments. With ``--checkpoint-dir`` the sweep
    snapshots every segment boundary and resumes from the newest
    snapshot. ``--max-segments N`` hard-exits the process (code 3) right
    after the N-th snapshot, a deterministic boundary preemption;
    ``--sleep S`` sleeps after each snapshot to widen the window for a
    real SIGTERM. ``--torch-device`` names the device (default cuda).
    The last line of its output is a JSON object with the sweep's wall
    time, its cells and the process's ``prefix_select`` launches.

``check``
    The full lane: an uninterrupted reference run, a live worker
    SIGTERMed after its first snapshot appears, a rerun that resumes,
    and an assertion that the resumed frontiers are bit-identical to the
    reference's.

Usage::

    PYTHONPATH=src python scripts/torch_resume_worker.py check
    PYTHONPATH=src python scripts/torch_resume_worker.py run \\
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

# the tiny sweep: big enough for 4 boundaries, small enough for a test
KEY = 5
SEGMENT = 2
SWEEPS = 8
REGIONS = {"hydro": 0.024, "coal-heavy": 0.82}
NORM_SAMPLES = 80
# the run_scenarios() defaults grid
DEFAULTS_KEY = 0
DEFAULTS_SEGMENT = 10


def run_grid(grid: str, checkpoint_dir, torch_device):
    from repro_torch.core import workload
    from repro_torch.pathfinding import (
        Pathfinder,
        ScalarizationSweep,
        ScenarioSweep,
    )

    if grid == "defaults":
        pf = Pathfinder(workload(1), "T1", torch_device=torch_device)
        return pf.run_scenarios(workloads=[workload(1), workload(6)],
                                key=DEFAULTS_KEY, segment=DEFAULTS_SEGMENT,
                                checkpoint_dir=checkpoint_dir)
    sweep = ScenarioSweep(
        strategy=ScalarizationSweep(directions=2, n_chains=2,
                                    sweeps=SWEEPS),
        regions=dict(REGIONS), norm_samples=NORM_SAMPLES)
    return sweep.run(workload(1), key=KEY, segment=SEGMENT,
                     checkpoint_dir=checkpoint_dir,
                     torch_device=torch_device)


def preempt_after(max_segments: int, sleep: float) -> None:
    """Make every snapshot sleep ``sleep`` s and the ``max_segments``-th
    one exit the process at once (code 3, no cleanup, as a preemption
    would), by wrapping ``SearchCheckpointer.save``."""
    from repro_torch.pathfinding.resume import SearchCheckpointer

    orig_save = SearchCheckpointer.save
    state = {"saves": 0}

    def save(self, *a, **kw):
        path = orig_save(self, *a, **kw)
        state["saves"] += 1
        if sleep:
            time.sleep(sleep)
        if max_segments and state["saves"] >= max_segments:
            os._exit(3)
        return path

    SearchCheckpointer.save = save


def launch_count() -> int:
    """``prefix_select`` kernel launches in this process so far (zero
    off cuda, where its plain version runs)."""
    from repro_torch.kernels.prefix_gather import ops

    return ops.launch_count()


def cmd_run(args: argparse.Namespace) -> int:
    if args.max_segments or args.sleep:
        preempt_after(args.max_segments, args.sleep)
    t = time.perf_counter()
    sf = run_grid(args.grid, args.checkpoint_dir, args.torch_device)
    wall = time.perf_counter() - t
    if args.out:
        payload = {}
        for i, s in enumerate(sf.scenarios):
            res = sf.results[s.key]
            payload[f"enc_{i}"] = res.frontier.encoded
            payload[f"vec_{i}"] = res.frontier.vectors
            payload[f"hist_{i}"] = np.asarray(res.history)
            payload[f"best_cost_{i}"] = np.float64(res.best_cost)
        np.savez(args.out, **payload)
    print(f"sweep done: {len(sf.scenarios)} cells, "
          f"{sum(len(sf.results[s.key].frontier) for s in sf.scenarios)} "
          f"frontier points")
    print(json.dumps(dict(wall_s=wall, cells=len(sf.scenarios),
                          launches=launch_count())))
    return 0


def _finished_steps(directory: str):
    """Completed snapshot dirs only: a torn ``step_N.tmp`` satisfies
    neither the SIGTERM wait nor the survived-the-kill assertion."""
    return [d for d in glob.glob(os.path.join(directory, "step_*"))
            if not d.endswith(".tmp")
            and os.path.exists(os.path.join(d, "checkpoint.json"))]


def _wait_for_checkpoint(directory: str, proc: subprocess.Popen,
                         timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return False  # finished (or died) before any snapshot
        if _finished_steps(directory):
            return True
        time.sleep(0.05)
    return False


def cmd_check(args: argparse.Namespace) -> int:
    workdir = args.workdir or tempfile.mkdtemp(prefix="kill-resume-")
    os.makedirs(workdir, exist_ok=True)
    me = os.path.abspath(__file__)
    common = ["--grid", args.grid] + (
        ["--torch-device", args.torch_device] if args.torch_device else [])

    def worker(*extra: str) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, me, "run", *common,
                                 *extra])

    ref_npz = os.path.join(workdir, "reference.npz")
    res_npz = os.path.join(workdir, "resumed.npz")
    ckpt = os.path.join(workdir, "ckpt")

    print("[1/4] uninterrupted reference run", flush=True)
    if worker("--out", ref_npz).wait() != 0:
        raise RuntimeError("reference run failed")

    print("[2/4] live run + SIGTERM after first checkpoint", flush=True)
    killed = False
    for attempt, sleep_s in enumerate((1.0, 3.0), 1):
        # a fresh directory per attempt: stale snapshots of an attempt
        # that finished before its SIGTERM must not satisfy the wait
        shutil.rmtree(ckpt, ignore_errors=True)
        proc = worker("--checkpoint-dir", ckpt, "--sleep", str(sleep_s))
        if _wait_for_checkpoint(ckpt, proc, timeout=args.timeout):
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
            print(f"    SIGTERM delivered (attempt {attempt}), "
                  f"worker exit code {rc}", flush=True)
            if rc == 0:
                raise RuntimeError("worker survived SIGTERM")
            killed = True
            break
        proc.wait()
        print(f"    attempt {attempt}: run finished before SIGTERM "
              "window; widening sleep", flush=True)
    if not killed:
        raise RuntimeError("could not interrupt the worker mid-run")
    steps = _finished_steps(ckpt)
    if not steps:
        raise RuntimeError("no checkpoint survived the kill")
    print(f"    checkpoints on disk: "
          f"{sorted(os.path.basename(s) for s in steps)}", flush=True)

    print("[3/4] resume from newest valid checkpoint", flush=True)
    if worker("--checkpoint-dir", ckpt, "--out", res_npz).wait() != 0:
        raise RuntimeError("resume failed")

    print("[4/4] bit-identical frontier comparison", flush=True)
    a, b = np.load(ref_npz), np.load(res_npz)
    if set(a.files) != set(b.files):
        print(f"MISMATCH in files: {a.files} vs {b.files}")
        return 1
    for k in sorted(a.files):
        if not np.array_equal(a[k], b[k]):
            print(f"MISMATCH in {k}:\nref={a[k]!r}\nres={b[k]!r}")
            return 1
    print(f"kill-and-resume OK: {len(a.files)} arrays bit-identical "
          f"(workdir {workdir})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="one sweep invocation")
    chk = sub.add_parser("check", help="full kill-and-resume proof")
    for p in (run, chk):
        p.add_argument("--grid", choices=("tiny", "defaults"),
                       default="tiny")
        p.add_argument("--torch-device", default=None,
                       help="torch device (default: cuda)")
    run.add_argument("--checkpoint-dir", default=None)
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
