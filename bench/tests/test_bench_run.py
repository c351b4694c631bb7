"""A run of each cell on the CPU at a tiny size, in a process of its own
(the harness refuses a process that has JAX loaded): a well-formed result
line, traced and not; ``bench/run.py`` refusing to run without a card;
and, on a card, one short run of each cell. The faults are in
``test_bench_faults.py``."""
import json
import subprocess
import sys

import pytest

from bench.harness.cell import ROOT, load_json
from cpu_run import run_in_subprocess, subprocess_env

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    line, err = run_in_subprocess("--workload", cell, "--trace", str(trace))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"] for m in SPEC[kind]
             if cell in m.get("workloads", [cell])}
    for name, m in line["metrics"].items():
        assert names[name] == m["unit"]
        assert isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(names)
    else:
        # no device here: the device trace's metrics find nothing to read
        assert {"facade_ms", "sweep_ms"} <= set(line["metrics"])
        assert "breakdown" in line
    for k, v in line["checks"].items():
        assert f"check {k}: " in err
        assert v["value"] <= v["limit"]


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=subprocess_env(), timeout=300,
        cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell,
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=subprocess_env(), timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
