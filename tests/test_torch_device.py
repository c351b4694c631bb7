"""The port's fused device evaluator and move generator against the
reference's ``DeviceEvaluator`` (run on the CPU with its plain jnp
gather, as its own tests run it).

Tolerances: metrics, costs and objective vectors within 1e-6 relative
(float64 on both sides; reductions may sum in another order); proposals
bit-equal (same threefry draws, integer arithmetic); the neutral mesh
``(1,1)``+corner and the neutral schedule ``(0,0)`` exactly invisible."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.convert import normalizer_from_arrays, techdb_from_fields
from repro_torch.core import TEMPLATES, workload
from repro_torch.core.techdb import DEFAULT_DB
from repro_torch.pathfinding.batch import MetricsBatch
from repro_torch.pathfinding import evaluate_batch_device
from repro_torch.pathfinding.device import (
    DeviceEvaluator,
    _validity,
    propose_batch,
)
from repro_torch.pathfinding.space import DesignSpace

RTOL = 1e-6
N_SYS = 240
FIELDS = list(MetricsBatch.__dataclass_fields__)
# (comm, schedule, regional db?)
CASES = [("legacy", "fixed", False), ("legacy", "fixed", True),
         ("mesh_noc", "fixed", True), ("legacy", "window", True),
         ("mesh_noc", "window", True)]
MINS = np.array([1e-4, 10.0, 1e-5, 50.0, 5.0, 1.0])
MEDS = np.array([2e-3, 300.0, 3e-4, 400.0, 60.0, 9.0])
SEEDS = [0, 5]

REF = """
import dataclasses, json
from repro.core import TEMPLATES, workload
from repro.core.techdb import DEFAULT_DB
from repro.core.templates import METRIC_FIELDS, Normalizer
from repro.pathfinding.device import DeviceEvaluator
from repro.pathfinding.space import DesignSpace
grid = tuple(float(x) for x in inp["grid"])
price = tuple(float(x) for x in inp["price"])
regional = dataclasses.replace(
    DEFAULT_DB, grid_profile=grid, price_profile=price,
    electricity_price=0.13, emb_factor=1.25, carbon_intensity=0.42)
out["regional_db"] = np.array(json.dumps(dataclasses.asdict(regional)))
norm = Normalizer(dict(zip(METRIC_FIELDS, inp["mins"].tolist())),
                  dict(zip(METRIC_FIELDS, inp["meds"].tolist())))
CASES = [("legacy", "fixed", False), ("legacy", "fixed", True),
         ("mesh_noc", "fixed", True), ("legacy", "window", True),
         ("mesh_noc", "window", True)]
for ci, (comm, sched, reg) in enumerate(CASES):
    sp = DesignSpace(comm=comm, schedule=sched)
    db = regional if reg else DEFAULT_DB
    ev = DeviceEvaluator(workload(1), db, space=sp)
    enc = inp[f"enc{ci}"]
    mb, cost, vec = ev.evaluate_cost_vector(enc, norm, TEMPLATES["T2"])
    for f, a in mb.__dict__.items():
        out[f"mb{ci}_{f}"] = a
    out[f"cost{ci}"], out[f"vec{ci}"] = cost, vec
    for s in (0, 5):
        out[f"prop{ci}_{s}"] = ev.propose(enc, seed=s)
"""


def _profiles():
    h = np.arange(24)
    grid = 0.42 + 0.2 * np.sin(h / 24 * 2 * np.pi)
    price = 0.13 + 0.05 * np.cos(h / 24 * 2 * np.pi + 1.0)
    return grid, price


@pytest.fixture(scope="module")
def encs():
    out = {}
    for ci, (c, s, _) in enumerate(CASES):
        enc = DesignSpace(comm=c, schedule=s).sample(N_SYS, key=100 + ci)
        styles = set(enc[:, 1].tolist())
        assert styles == {0, 1, 2, 3}, styles   # 2D, 2.5D, 3D and hybrid
        out[ci] = enc
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory, encs):
    grid, price = _profiles()
    inputs = {f"enc{ci}": e for ci, e in encs.items()}
    inputs.update(grid=grid, price=price, mins=MINS, meds=MEDS)
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_device"))


@pytest.fixture(scope="module")
def evaluators(ref):
    regional = techdb_from_fields(json.loads(str(ref["regional_db"])))
    return {ci: DeviceEvaluator(workload(1), regional if reg else DEFAULT_DB,
                                space=DesignSpace(comm=c, schedule=s),
                                torch_device="cpu")
            for ci, (c, s, reg) in enumerate(CASES)}


def test_regional_techdb_carried_over(ref, evaluators):
    db = evaluators[1].db
    grid, price = _profiles()
    np.testing.assert_array_equal(db.grid_profile, grid)
    np.testing.assert_array_equal(db.price_profile, price)
    assert (db.electricity_price, db.emb_factor, db.carbon_intensity) == \
        (0.13, 1.25, 0.42)
    default = dataclasses.asdict(DEFAULT_DB)
    for k, v in dataclasses.asdict(db).items():
        if k not in ("grid_profile", "price_profile", "electricity_price",
                     "emb_factor", "carbon_intensity"):
            assert v == default[k], k


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_evaluate_cost_vector_within_tolerance(ref, encs, evaluators, ci):
    norm = normalizer_from_arrays(MINS, MEDS)
    mb, cost, vec = evaluators[ci].evaluate_cost_vector(
        encs[ci], norm, TEMPLATES["T2"])
    for f in FIELDS:
        np.testing.assert_allclose(getattr(mb, f), ref[f"mb{ci}_{f}"],
                                   rtol=RTOL, atol=0, err_msg=f)
    np.testing.assert_allclose(cost, ref[f"cost{ci}"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(vec, ref[f"vec{ci}"], rtol=RTOL, atol=0)
    mb2, cost2 = evaluators[ci].evaluate_cost(encs[ci], norm,
                                              TEMPLATES["T2"])
    np.testing.assert_array_equal(cost2, cost)
    raw = evaluators[ci].metrics(encs[ci])
    np.testing.assert_array_equal(raw.latency_s, mb.latency_s)


def test_evaluate_batch_device_matches_reference(ref, encs):
    """The functional entry (the reference's ``evaluate_batch_device``)
    on the default space and TechDB: case 0's metrics."""
    mb = evaluate_batch_device(encs[0], workload(1), torch_device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(mb, f), ref[f"mb0_{f}"],
                                   rtol=RTOL, atol=0, err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_propose_bit_equal(ref, encs, evaluators, ci, seed):
    ev = evaluators[ci]
    got = ev.propose(encs[ci], seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref[f"prop{ci}_{seed}"])
    np.testing.assert_array_equal(
        propose_batch(encs[ci], workload(1), ev.db, space=ev.space,
                      seed=seed, torch_device="cpu"), got)
    assert (got != encs[ci]).any(axis=1).mean() > 0.5


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_validity_matches_design_space(encs, evaluators, ci):
    ev = evaluators[ci]
    rng = np.random.default_rng(ci)
    v = encs[ci].astype(np.int64)
    hit = rng.random(v.shape) < 0.05
    v[hit] += rng.integers(-2, 3, int(hit.sum()))
    got = _validity(torch.as_tensor(v), ev.tables, ev.cfg).numpy()
    np.testing.assert_array_equal(got, ev.space.validity_mask(v))


@pytest.mark.parametrize("comm,sched", [("mesh_noc", "fixed"),
                                        ("legacy", "window"),
                                        ("mesh_noc", "window")])
@pytest.mark.parametrize("regional", [False, True])
def test_neutral_mesh_and_schedule_bit_invisible(ref, comm, sched, regional):
    """Legacy/fixed designs re-encoded with the neutral (1x1, corner)
    NoC pairs and the neutral (0, 0) schedule evaluate bit-identically."""
    db = (techdb_from_fields(json.loads(str(ref["regional_db"])))
          if regional else DEFAULT_DB)
    base = DesignSpace(db)
    wide = DesignSpace(db, comm=comm, schedule=sched)
    enc = base.sample(N_SYS, key=77)
    enc_w = wide.encode_many(base.decode_many(enc))
    assert enc_w.shape[1] > enc.shape[1]
    norm = normalizer_from_arrays(MINS, MEDS)
    a = DeviceEvaluator(workload(1), db, space=base, torch_device="cpu")
    b = DeviceEvaluator(workload(1), db, space=wide, torch_device="cpu")
    mb_a, cost_a, vec_a = a.evaluate_cost_vector(enc, norm, TEMPLATES["T1"])
    mb_b, cost_b, vec_b = b.evaluate_cost_vector(enc_w, norm, TEMPLATES["T1"])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mb_a, f), getattr(mb_b, f),
                                      err_msg=f)
    np.testing.assert_array_equal(cost_a, cost_b)
    np.testing.assert_array_equal(vec_a, vec_b)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        DeviceEvaluator(workload(1))
