"""With the timed path broken underneath, a run's check comes out not
correct: once for each fault of ``bench/harness/faults.py`` (a step that
returns its state unchanged, half of the batch left out with the mean of
the rest in its place, an answer altered where it is produced, the
replica exchange skipped, every proposal accepted, a best design that is
not the best). The cells share one engine and one judge; the cells run
on one chip, so no exchange between chips can be left out."""
import pytest

from bench.harness.faults import FAULTS
from cpu_run import run_in_subprocess

CELL = "pt-wl1-default"


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    line, _ = run_in_subprocess("--workload", CELL, "--fault", fault)
    assert line["correct"] is False
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over, line["checks"]
