"""The readings that the limits of a cell's check are set from.

    python3 bench/readings.py --workload <name> --seeds 11,12,... \
        [--faults unchanged,no_exchange,...] [--out FILE]

On the card, in one process: the cell's set-up once, then for each seed
one call of the cell's traffic (key ``seed * KEY_STRIDE``), captured as
the window captures it, and the numbers that the cell's judge compares,
read three ways:

- ``program``: what the program returned, judged by the float64
  reference: the lower readings of the limits;
- ``control``: the reference itself computed in float32 (every float of
  the technology database as ``numpy.float32``), put in the program's
  place for the same designs and judged the same way: the upper readings;
- with ``--faults``, for each fault of ``bench/harness/faults.py``, the
  program with that fault planted, on the same key.

The benchmark's own runs do not run this. Each seed's readings are one
JSON line on standard output (and in ``--out``).
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args()
    from bench.harness.cell import Hooks, Program, load_cell, load_module
    from bench.harness.faults import planted
    from bench.reference import Reference

    cell = load_cell(args.workload)
    traffic = cell["traffic"]
    judge = load_module("judges", traffic["judge"])
    program = Program(cell, args.device)
    program.fit()
    ref64 = Reference(cell["config"])
    ref32 = Reference(cell["config"], float32=True)
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None

    def one_call(seed: int):
        capture = judge.Capture()
        driver = load_module("drivers", traffic["driver"]).Driver(
            program, traffic, Hooks(capture, {}, args.device))
        wraps = capture.wraps()
        for w in wraps:
            w.__enter__()
        try:
            driver.extra(seed, 0)
        finally:
            for w in reversed(wraps):
                w.__exit__(None, None, None)
        return capture.calls

    for seed in (int(s) for s in args.seeds.split(",")):
        calls = one_call(seed)
        rec = dict(workload=args.workload, seed=seed,
                   program=judge.judge(ref64, calls, seed, traffic),
                   control=judge.judge(ref64,
                                       judge.control(ref32, calls, traffic),
                                       seed, traffic))
        for f in faults:
            with planted(f):
                rec[f] = judge.judge(ref64, one_call(seed), seed, traffic)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
