"""Count the float64 operations of a cell's sweep on the CPU and print the
cell's ``work`` block for ``bench/cells/<cell>.json``.

    PYTHONPATH=src python3 bench/count_work.py --workload <name>

The count is taken by :class:`bench.harness.work.F64Counter` over the
engine at two small populations and extended linearly in the rows (every
operation of a sweep is elementwise over its rows, or over one pair of
rows in the replica exchange). The CPU and the card run the same aten
ops but for ``prefix_select``, whose int64 work counts no float64
operation on either. The block is frozen into the cell's file, so that a
later change to the program does not move the yardstick.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the least bytes of a sweep, a row at a time: the population read and
# written as int32 (the proposals and the accepted rows), and the float64
# outputs written (the cost and the objective vector)
BYTES = dict(rows_read=1, rows_written=2, f64_written=4)


def _count(program, rows: int, traffic: dict) -> float:
    import numpy as np

    from bench.harness.work import F64Counter
    from repro_torch.pathfinding import DeviceEvaluator

    pf, space = program.pf, program.space
    dev = pf.objective()._device_evaluator(space)
    v0 = space.sample(rows, key=rows)
    params = traffic["strategy"]["params"]
    k = int(params["swap_every"])
    temps = np.geomspace(params["t_max"], params["t_min"], rows)
    counts = []
    for sweeps in (0, k):
        c = F64Counter()
        with c.mode():
            DeviceEvaluator.parallel_tempering(
                dev, v0, temps, sweeps, k, seed=1, norm=pf.norm,
                template=pf.template, collect_samples=False)
        counts.append(c.ops)
    return (counts[1] - counts[0]) / k      # one sweep, exchange averaged


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    args = p.parse_args()
    from bench.harness.cell import Program, load_cell
    from bench.harness.work import linear_fit

    cell = load_cell(args.workload)
    program = Program(cell, "cpu")
    program.fit()
    (p1, p2) = (256, 1024)
    c1 = _count(program, p1, cell["traffic"])
    c2 = _count(program, p2, cell["traffic"])
    fit = linear_fit(p1, c1, p2, c2)
    print(json.dumps(dict(f64_ops_per_row=fit["per_row"],
                          f64_ops_fixed=fit["fixed"],
                          counted_at=[[p1, c1], [p2, c2]],
                          bytes_per_row=BYTES), indent=1))


if __name__ == "__main__":
    main()
