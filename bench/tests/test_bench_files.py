"""The benchmark's files: every configuration, traffic mix (with its
driver and judge), cell and metric loads by the name ``BENCHMARK.json``
gives it, every
name and unit keeps to the benchmark's characters, and no module under
``bench/`` imports JAX or the JAX package."""
import ast
import json
import re
from pathlib import Path

import pytest

from bench.harness.cell import BENCH, ROOT, load_cell, load_json, load_module

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
JUDGED = dict(tempering={"cost_gap", "invalid", "replay", "unmoved",
                         "trajectory", "frontier"})


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["traffic"] for w in SPEC["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = load_cell(cell)
    assert set(c["limits"]) == JUDGED[c["traffic"]["judge"]]
    assert c["work"]["f64_ops_per_row"] > 0
    driver = load_module("drivers", c["traffic"]["driver"])
    strategy = driver.build(c["traffic"]["strategy"])
    assert type(strategy).__name__ == c["traffic"]["strategy"]["class"]
    for key in ("comm", "schedule", "template", "max_chiplets",
                "norm_samples", "norm_seed", "workloads"):
        assert key in c["config"], key
    assert c["config"]["reduced"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads(metric):
    read = load_module("metrics", metric).read
    assert read(dict(calls=[], trace=None, bound={}, work={}, width=27,
                     window_s=0.0, evaluations=0)) is None


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]])
def test_end_to_end_reader_reads_the_window(metric):
    read = load_module("metrics", metric).read
    value = read(dict(calls=[dict(call_s=2.0, evaluations=100)],
                      window_s=2.0, evaluations=100, setup_s=3.0))
    assert value == {"evals_per_s": 50.0, "setup_s": 3.0}[metric]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro",
                                   "benchmarks", "chip_smoke"}
    assert not found, found
    if path.parent.name == "reference":
        assert not set(_imports(path)) & {"repro_torch", "torch", "bench"}
