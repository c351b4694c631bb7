"""The slice as a whole: ``Pathfinder(...).search(ParallelTempering)``
in the port against a live run of the same call in the reference, and
against the checked-in golden ``device_pt_wl1_t1.json``.

Exact: best encoding, evaluations, the final chain population and every
proposal the engine made. Within 1e-6 relative: costs, the coldest-chain
history and the frontier (float64 on both sides, reductions may sum in
another order)."""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_support import REPO, run_reference

from repro_torch.convert import archive_from_arrays, normalizer_from_arrays
from repro_torch.core import TEMPLATES, workload
from repro_torch.pathfinding import (
    DesignSpace,
    ParallelTempering,
    ParetoArchive,
    Pathfinder,
    fit_normalizer_batched,
    get_device_evaluator,
)

RTOL = 1e-6

REF = """
import random as pyrandom
from repro.core import TEMPLATES, workload
from repro.core.sa import random_system
from repro.pathfinding import (
    DesignSpace, ParallelTempering, Pathfinder, fit_normalizer_batched)
from repro.pathfinding.device import get_device_evaluator
space = DesignSpace()
wl = workload(1)
norm = fit_normalizer_batched(wl, samples=400, seed=7, space=space)
out["mins"], out["meds"] = norm.weights_arrays()
pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space)
res = pf.search(strategy=ParallelTempering(n_chains=4, sweeps=20), key=3)
out["history"] = np.array(res.history)
out["best_cost"] = np.array(res.best_cost)
out["best_enc"] = space.encode(res.best)
out["evaluations"] = np.array(res.evaluations)
for k, a in res.frontier.checkpoint_arrays().items():
    out[f"front_{k}"] = a
dev = get_device_evaluator(wl, space=space)
r = dev.parallel_tempering(inp["v0"], inp["temps"], 12, 3, seed=11,
                           norm=norm, template=TEMPLATES["T3"])
out["pt_final_enc"], out["pt_final_costs"] = r.final_enc, r.final_costs
out["pt_samples_enc"], out["pt_samples_vec"] = (r.samples["enc"],
                                                r.samples["vec"])
out["pt_history"] = np.array(r.history)
pfh = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space, device=False)
rh = pfh.search(strategy=ParallelTempering(n_chains=4, sweeps=8), key=5)
out["host_history"] = np.array(rh.history)
out["host_best_enc"] = space.encode(rh.best)
"""

N_PT = 16


@pytest.fixture(scope="module")
def seed_pop():
    sp = DesignSpace()
    v0 = sp.sample(N_PT, key=99)
    temps = 5.0 * (0.05 ** (np.arange(N_PT) / (N_PT - 1)))
    return v0, temps


@pytest.fixture(scope="module")
def ref(tmp_path_factory, seed_pop):
    v0, temps = seed_pop
    return run_reference(REF, {"v0": v0, "temps": temps},
                         tmp_path_factory.mktemp("ref_pathfinder"),
                         timeout=400)


@pytest.fixture(scope="module")
def search():
    space = DesignSpace()
    wl = workload(1)
    norm = fit_normalizer_batched(wl, samples=400, seed=7, space=space,
                                  torch_device="cpu")
    pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space,
                    torch_device="cpu")
    res = pf.search(ParallelTempering(n_chains=4, sweeps=20), key=3)
    return pf, res


def test_search_matches_live_reference(ref, search):
    pf, res = search
    np.testing.assert_array_equal(pf.space.encode(res.best), ref["best_enc"])
    assert res.evaluations == int(ref["evaluations"]) == 84
    assert len(res.history) == len(ref["history"]) == 21
    np.testing.assert_allclose(res.history, ref["history"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(res.best_cost, ref["best_cost"], rtol=RTOL)
    mins, meds = pf.norm.weights_arrays()
    np.testing.assert_allclose(mins, ref["mins"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(meds, ref["meds"], rtol=RTOL, atol=0)


def test_frontier_matches_live_reference(ref, search):
    _, res = search
    carried = archive_from_arrays(
        {"enc": ref["front_enc"], "vec": ref["front_vec"]})
    assert isinstance(carried, ParetoArchive)
    np.testing.assert_array_equal(res.frontier.encoded, carried.encoded)
    np.testing.assert_allclose(res.frontier.vectors, carried.vectors,
                               rtol=RTOL, atol=0)


def test_search_replays_golden(search):
    _, res = search
    with open(os.path.join(REPO, "tests", "goldens",
                           "device_pt_wl1_t1.json")) as f:
        golden = json.load(f)
    assert len(res.frontier) >= 3
    assert res.evaluations == golden["evaluations"]
    got = {"history": res.history, "best_cost": res.best_cost,
           "frontier_latency_min": float(res.frontier.vectors[:, 0].min()),
           "frontier_cfp_min": float(res.frontier.vectors[:, 2].min())}
    for k, v in got.items():
        np.testing.assert_allclose(v, golden[k], rtol=RTOL, err_msg=k)


def test_engine_trajectory_bit_equal(ref, seed_pop):
    """Direct engine call with a carried-over normalizer, another
    template and swap period: every proposal and the final population
    are bit-equal, costs within tolerance."""
    v0, temps = seed_pop
    norm = normalizer_from_arrays(ref["mins"], ref["meds"])
    dev = get_device_evaluator(workload(1), space=DesignSpace(),
                               torch_device="cpu")
    r = dev.parallel_tempering(v0, temps, 12, 3, seed=11, norm=norm,
                               template=TEMPLATES["T3"])
    np.testing.assert_array_equal(r.samples["enc"], ref["pt_samples_enc"])
    np.testing.assert_array_equal(r.final_enc, ref["pt_final_enc"])
    np.testing.assert_allclose(r.samples["vec"], ref["pt_samples_vec"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(r.final_costs, ref["pt_final_costs"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(r.history, ref["pt_history"], rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("segment", [1, 5, 12])
def test_segments_are_invisible(ref, seed_pop, segment):
    v0, temps = seed_pop
    norm = normalizer_from_arrays(ref["mins"], ref["meds"])
    dev = get_device_evaluator(workload(1), space=DesignSpace(),
                               torch_device="cpu")
    whole = dev.parallel_tempering(v0, temps, 12, 3, seed=11, norm=norm,
                                   template=TEMPLATES["T3"])
    arch = ParetoArchive(max_size=64)
    part = dev.parallel_tempering(v0, temps, 12, 3, seed=11, norm=norm,
                                  template=TEMPLATES["T3"],
                                  segment=segment, archive=arch)
    np.testing.assert_array_equal(part.final_enc, whole.final_enc)
    assert part.history == whole.history
    direct = ParetoArchive(max_size=64)
    direct.insert(whole.samples["enc"][:1 + 12].reshape(-1, v0.shape[1]),
                  whole.samples["vec"][:1 + 12].reshape(-1, 3))
    if segment == 12:
        np.testing.assert_array_equal(arch.encoded, direct.encoded)
    assert len(arch) > 0


def test_host_path_matches_reference(ref):
    space = DesignSpace()
    norm = normalizer_from_arrays(ref["mins"], ref["meds"])
    pf = Pathfinder(workload(1), TEMPLATES["T1"], norm=norm, space=space,
                    device=False, torch_device="cpu")
    res = pf.search(ParallelTempering(n_chains=4, sweeps=8), key=5)
    np.testing.assert_array_equal(space.encode(res.best),
                                  ref["host_best_enc"])
    np.testing.assert_allclose(res.history, ref["host_history"], rtol=RTOL,
                               atol=0)


def test_checkpointed_search_writes_its_snapshot(tmp_path):
    """A checkpointed search writes its snapshot and raises nothing."""
    pf = Pathfinder(workload(1), norm=normalizer_from_arrays(
        np.zeros(6), np.ones(6)), torch_device="cpu")
    res = pf.search(ParallelTempering(n_chains=2, sweeps=1,
                                      checkpoint_dir=str(tmp_path)), key=0)
    assert len(res.history) == 2
    assert [d for d in os.listdir(tmp_path)] == ["step_00000001"]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        Pathfinder(workload(1))
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        fit_normalizer_batched(workload(1), samples=8)
