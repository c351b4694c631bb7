"""Drive one cell of the benchmark on the CPU at a tiny size, with the
timed path broken underneath if asked, and print the result line.

    PYTHONPATH=src python3 bench/tests/cpu_run.py --workload <name> \
        [--trace 1] [--fault <fault>] [--seed N]

It skips ``bench/run.py``'s look for a chip and runs the rest of a run
(set-up, window, traced window, check) through ``bench.harness.cell.run``
on the CPU, with the cell's strategy cut to :data:`TINY`. The faults are
those of ``bench/harness/faults.py``.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the strategy's parameters that a tiny run cuts
TINY = dict(n_chains=64, sweeps=12)


def subprocess_env() -> dict:
    """The environment of a run in a process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + [env.get("PYTHONPATH", "")])
    return env


def run_in_subprocess(*args):
    """This script in a process of its own: its result line and its
    standard error."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "tests" / "cpu_run.py"),
         *args], capture_output=True, text=True, env=subprocess_env(),
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", default="none")
    p.add_argument("--seed", type=int, default=2**31 + 7)
    args = p.parse_args(argv)
    from bench.harness.cell import load_cell, run
    from bench.harness.faults import planted

    strategy = load_cell(args.workload)["traffic"]["strategy"]
    tiny = dict(strategy=dict(strategy, params=dict(strategy["params"],
                                                    **TINY)))
    with (contextlib.nullcontext() if args.fault == "none"
          else planted(args.fault)):
        line = run(args.workload, args.seed, 0.5, bool(args.trace),
                   device="cpu", traffic_override=tiny)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
