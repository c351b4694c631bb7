"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; see ``bench/README.md``. The last line of standard output
is one JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error. Without as many CUDA devices
as the cell asks for, it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def pin() -> None:
    """Keep the process, and the threads it starts, on two fixed cores
    of its own set (the third and the fourth), the same in every run: the
    cells are paced by the host's issue of kernels, and a process left to
    move between cores ran at a less steady speed (see PERF.md)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, cores[2:4])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # every build and kernel cache of the program at a fixed path inside
    # the checkout (the program's own nvcc builds go to build/kernels)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    try:
        import torch

        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"cannot import the program: {e}", file=sys.stderr)
        return 3
    from bench.harness.cell import load_cell, run

    chips = load_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               "cuda", T_START)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
