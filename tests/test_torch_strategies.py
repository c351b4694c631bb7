"""The port's single-objective strategies and the ChipletGym backend
against a live run of the reference, and the SA golden ``sa_wl6_t1``.

Exact: encodings, evaluation counts, the SA move sequence (history
length, best design) and the exception types of the budget guards.
Within 1e-9 relative: the scalar SA path and the ChipletGym metrics
(the same float64 host arithmetic on both sides). Within 1e-6 relative:
costs and frontier vectors of the batched strategies (float64 on both
sides; reductions may sum in another order)."""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

from test_torch_support import REPO, run_reference

from repro_torch.core import (
    ALL_MAPPINGS,
    TEMPLATES,
    SAConfig,
    anneal,
    evaluate_chipletgym,
    fit_normalizer,
    workload,
)
from repro_torch.core.evaluate import Metrics
from repro_torch.pathfinding import (
    DesignSpace,
    GridSweep,
    Pathfinder,
    RandomSearch,
    SimulatedAnnealing,
)

RTOL = 1e-6
SA_RTOL = 1e-9
SA_SEEDS = (3, 8)
SA_BUDGET = 40
SA_CFG = dict(t_initial=50.0, t_final=0.05, cooling=0.85, moves_per_temp=6)
GRID = dict(memories=("DDR5",), n_mappings=2)
BUDGET_CASES = (0, 2.5, True)

REF = """
from repro.core import SAConfig, TEMPLATES, workload
from repro.core.chipletgym import evaluate_chipletgym
from repro.core.sa import anneal, fit_normalizer
from repro.core.workload import ALL_MAPPINGS
from repro.pathfinding import (
    DesignSpace, GridSweep, Pathfinder, RandomSearch, SimulatedAnnealing)
space = DesignSpace()
wl = workload(1)
norm = fit_normalizer(wl, samples=120, seed=7)
out["mins"], out["meds"] = norm.weights_arrays()

def keep(tag, pf, res):
    out[tag + "history"] = np.array(res.history)
    out[tag + "best_cost"] = np.array(res.best_cost)
    out[tag + "best_enc"] = pf.space.encode(res.best)
    out[tag + "evaluations"] = np.array(res.evaluations)
    if res.frontier is not None:
        out[tag + "front_enc"] = res.frontier.encoded
        out[tag + "front_vec"] = res.frontier.vectors

pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space)
for s in SEEDS:
    cfg = SAConfig(seed=s, **CFG)
    keep(f"sa{s}/", pf, pf.search(SimulatedAnnealing(cfg), budget=BUDGET))
res = anneal(wl, TEMPLATES["T1"], config=SAConfig(seed=5, **CFG), norm=norm)
out["anneal/history"] = np.array(res.history)
out["anneal/evaluations"] = np.array(res.evaluations)
grid = GridSweep(memories=GRID["memories"],
                 mappings=ALL_MAPPINGS[:GRID["n_mappings"]])
for dev in (True, False):
    pfd = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space,
                     device=dev)
    keep(f"rs{dev}/", pfd,
         pfd.search(RandomSearch(batch_size=32), budget=100, key=2))
    keep(f"gs{dev}/", pfd, pfd.search(grid, key=1))
for name in ("sa", "rs", "gs"):
    for i, b in enumerate(BUDGETS):
        strat = {"sa": SimulatedAnnealing(), "rs": RandomSearch(),
                 "gs": grid}[name]
        try:
            pf.search(strat, budget=b)
            out[f"guard/{name}{i}"] = np.array("none")
        except Exception as e:
            out[f"guard/{name}{i}"] = np.array(type(e).__name__)
sys_ = space.decode_many(inp["systems"])
mets = [evaluate_chipletgym(s, wl) for s in sys_]
for f in ("latency_s", "energy_j", "area_mm2", "dollar", "emb_cfp_kg",
          "ope_cfp_kg", "l_compute_rd_s", "l_d2d_s", "l_dram_wr_s",
          "e_compute_j", "e_d2d_j", "d2d_bits", "macs"):
    out["cg/" + f] = np.array([getattr(m, f) for m in mets])
pfg = Pathfinder(wl, TEMPLATES["T1"], objective="chipletgym", space=space)
pfg.fit_normalizer(samples=60, seed=4)
gmins, gmeds = pfg.norm.weights_arrays()
out["cgnorm"] = np.concatenate([gmins, gmeds])
keep("cgsa/", pfg, pfg.search(SimulatedAnnealing(SAConfig(seed=6, **CFG)),
                              budget=BUDGET))
mb = pfg.evaluate_batch(inp["systems"][:8])
out["cgbatch"] = mb.objective_vectors()
"""


@pytest.fixture(scope="module")
def systems():
    return DesignSpace().sample(50, key=21)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, systems):
    consts = (f"SEEDS = {SA_SEEDS!r}\nBUDGET = {SA_BUDGET}\nCFG = {SA_CFG!r}"
              f"\nGRID = {GRID!r}\nBUDGETS = {BUDGET_CASES!r}\n")
    return run_reference(consts + REF, {"systems": systems},
                         tmp_path_factory.mktemp("ref_strategies"),
                         timeout=400)


@pytest.fixture(scope="module")
def norm():
    return fit_normalizer(workload(1), samples=120, seed=7)


def _pf(norm, **kw):
    return Pathfinder(workload(1), TEMPLATES["T1"], norm=norm,
                      space=DesignSpace(), torch_device="cpu", **kw)


def _grid():
    return GridSweep(memories=GRID["memories"],
                     mappings=ALL_MAPPINGS[:GRID["n_mappings"]])


def _check(ref, tag, pf, res, rtol=RTOL):
    np.testing.assert_array_equal(pf.space.encode(res.best),
                                  ref[tag + "best_enc"])
    assert res.evaluations == int(ref[tag + "evaluations"])
    assert len(res.history) == len(ref[tag + "history"])
    np.testing.assert_allclose(res.history, ref[tag + "history"], rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(res.best_cost, ref[tag + "best_cost"],
                               rtol=rtol)
    if res.frontier is not None:
        np.testing.assert_array_equal(res.frontier.encoded,
                                      ref[tag + "front_enc"])
        np.testing.assert_allclose(res.frontier.vectors,
                                   ref[tag + "front_vec"], rtol=rtol, atol=0)


def test_sa_replays_golden():
    """``tests/goldens/sa_wl6_t1.json`` as ``tests/test_goldens.py``
    drives the reference: the default strategy of ``search()``."""
    pf = Pathfinder(workload(6), TEMPLATES["T1"], torch_device="cpu")
    pf.fit_normalizer(samples=200, seed=1, method="scalar")
    cfg = SAConfig(t_initial=50.0, t_final=0.05, cooling=0.85,
                   moves_per_temp=15, seed=2)
    pf_default = Pathfinder(workload(6), TEMPLATES["T1"], norm=pf.norm,
                            torch_device="cpu")
    res = pf.search(SimulatedAnnealing(cfg))
    with open(os.path.join(REPO, "tests", "goldens", "sa_wl6_t1.json")) as f:
        golden = json.load(f)
    assert res.evaluations == golden["evaluations"]
    assert res.best.describe() == golden["best"]
    np.testing.assert_allclose(res.history, golden["history"],
                               rtol=SA_RTOL)
    np.testing.assert_allclose(res.best_cost, golden["best_cost"],
                               rtol=SA_RTOL)
    # search() with no strategy is SimulatedAnnealing() at SAConfig()
    dflt = pf_default.search(budget=30)
    same = pf_default.search(SimulatedAnnealing(), budget=30)
    assert dflt.history == same.history and dflt.evaluations == 30


def test_normalizer_matches_reference(ref, norm):
    mins, meds = norm.weights_arrays()
    np.testing.assert_allclose(mins, ref["mins"], rtol=SA_RTOL, atol=0)
    np.testing.assert_allclose(meds, ref["meds"], rtol=SA_RTOL, atol=0)


@pytest.mark.parametrize("seed", SA_SEEDS)
def test_sa_trajectory_matches_reference(ref, norm, seed):
    pf = _pf(norm)
    res = pf.search(SimulatedAnnealing(SAConfig(seed=seed, **SA_CFG)),
                    budget=SA_BUDGET)
    assert res.evaluations == SA_BUDGET
    _check(ref, f"sa{seed}/", pf, res, rtol=SA_RTOL)


def test_sa_key_defers_to_config_seed(norm):
    pf = _pf(norm)
    strat = SimulatedAnnealing(SAConfig(seed=3, **SA_CFG), frontier_size=0)
    a = pf.search(strat, budget=20)
    b = pf.search(strat, budget=20, key=3)
    c = pf.search(strat, budget=20, key=4)
    assert a.history == b.history and a.frontier is None
    assert a.history != c.history


def test_anneal_shim(ref, norm):
    cfg = SAConfig(seed=5, **SA_CFG)
    with pytest.warns(DeprecationWarning, match="repro_torch.pathfinding"):
        res = anneal(workload(1), TEMPLATES["T1"], config=cfg, norm=norm,
                     torch_device="cpu")
    direct = _pf(norm).search(SimulatedAnnealing(cfg))
    assert res.history == direct.history
    assert res.evaluations == direct.evaluations
    assert res.best == direct.best
    assert not hasattr(res, "frontier")
    assert res.evaluations == int(ref["anneal/evaluations"])
    np.testing.assert_allclose(res.history, ref["anneal/history"],
                               rtol=SA_RTOL, atol=0)


@pytest.mark.parametrize("device", [True, False])
def test_random_search_matches_reference(ref, norm, device):
    pf = _pf(norm, device=device)
    res = pf.search(RandomSearch(batch_size=32), budget=100, key=2)
    assert res.evaluations == 100 and len(res.history) == 4
    _check(ref, f"rs{device}/", pf, res)


@pytest.mark.parametrize("device", [True, False])
def test_grid_sweep_matches_reference(ref, norm, device):
    pf = _pf(norm, device=device)
    res = pf.search(_grid(), key=1)
    assert res.evaluations == len(_grid().systems(pf.db)) == 2 * 43
    _check(ref, f"gs{device}/", pf, res)


def test_grid_sweep_systems():
    """The full default grid: 4 memories x 12 mappings x 43 package
    combinations, every system valid and distinct."""
    sp = DesignSpace()
    systems = GridSweep().systems(sp.db)
    assert len(systems) == 4 * 12 * 43
    enc = sp.encode_many(systems)
    assert sp.validity_mask(enc).all()
    assert len(np.unique(enc, axis=0)) == len(systems)


@pytest.mark.parametrize("name", ["sa", "rs", "gs"])
@pytest.mark.parametrize("case", range(len(BUDGET_CASES)))
def test_budget_guards_match_reference(ref, norm, name, case):
    strat = {"sa": SimulatedAnnealing(), "rs": RandomSearch(),
             "gs": _grid()}[name]
    want = str(ref[f"guard/{name}{case}"])
    assert want in ("TypeError", "ValueError")
    with pytest.raises((TypeError, ValueError)) as e:
        _pf(norm).search(strat, budget=BUDGET_CASES[case])
    assert type(e.value).__name__ == want


def test_chipletgym_metrics_match_reference(ref, systems):
    wl = workload(1)
    mets = [evaluate_chipletgym(s, wl)
            for s in DesignSpace().decode_many(systems)]
    for f in dataclasses.fields(Metrics):
        got = np.array([getattr(m, f.name) for m in mets])
        want = ref["cg/" + f.name]
        if f.name in ("d2d_bits", "macs"):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=SA_RTOL, atol=0,
                                       err_msg=f.name)


def test_chipletgym_search_matches_reference(ref):
    pf = Pathfinder(workload(1), TEMPLATES["T1"], objective="chipletgym",
                    space=DesignSpace(), torch_device="cpu")
    assert not pf.batched and not pf.device
    pf.fit_normalizer(samples=60, seed=4)
    np.testing.assert_allclose(np.concatenate(pf.norm.weights_arrays()),
                               ref["cgnorm"], rtol=SA_RTOL, atol=0)
    res = pf.search(SimulatedAnnealing(SAConfig(seed=6, **SA_CFG)),
                    budget=SA_BUDGET)
    _check(ref, "cgsa/", pf, res, rtol=SA_RTOL)


def test_chipletgym_batch_matches_reference(ref, systems):
    """The non-batched branch of ``evaluate_batch``: scalar rows under
    the identity normalizer, before any normalizer is fitted."""
    pf = Pathfinder(workload(1), TEMPLATES["T1"], objective="chipletgym",
                    torch_device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mb = pf.evaluate_batch(systems[:8])
    assert pf._norm is None
    np.testing.assert_allclose(mb.objective_vectors(), ref["cgbatch"],
                               rtol=SA_RTOL, atol=0)
    m = pf.evaluate(pf.space.decode(systems[0]))
    np.testing.assert_allclose(m.latency_s, ref["cg/latency_s"][0],
                               rtol=SA_RTOL)


def test_facade_evaluation_paths_agree(norm, systems):
    """``evaluate_batch`` (batched), ``evaluate_cost_vector`` (fused) and
    scalar ``evaluate`` of the carbonpath backend agree."""
    pf = _pf(norm)
    enc = systems[:16]
    mb = pf.evaluate_batch(enc)
    mb2, cost, vec = pf.evaluate_cost_vector(enc)
    np.testing.assert_allclose(mb.objective_vectors(), vec, rtol=RTOL)
    np.testing.assert_allclose(mb2.objective_vectors(), vec, rtol=RTOL)
    obj = pf.objective()
    for i in (0, 7):
        m = pf.evaluate(pf.space.decode(enc[i]))
        np.testing.assert_allclose(obj.cost(m), cost[i], rtol=RTOL)
        np.testing.assert_allclose(obj.cost_vector(m), vec[i], rtol=RTOL)
    _, cost2 = obj.eval_cost_encoded(enc, pf.space)
    np.testing.assert_array_equal(cost2, cost)


def _checkpointed(strategy, ckpt):
    from repro_torch.pathfinding import ParallelTempering, ScalarizationSweep

    return (ParallelTempering(n_chains=2, sweeps=1, checkpoint_dir=ckpt)
            if strategy == "pt" else
            ScalarizationSweep(directions=2, n_chains=2, sweeps=1,
                               checkpoint_dir=ckpt))


@pytest.mark.parametrize("strategy", ["pt", "sweep"])
def test_device_engine_checkpoints_like_the_plain_run(norm, strategy,
                                                      tmp_path):
    """The device engine checkpoints (one snapshot after the one
    segment) and returns what the plain run returns."""
    ckpt = str(tmp_path / "x")
    strat = _checkpointed(strategy, ckpt)
    got = _pf(norm, device=True).search(strat, key=0)
    plain = _pf(norm, device=True).search(
        dataclasses.replace(strat, checkpoint_dir=None), key=0)
    assert os.listdir(ckpt) == ["step_00000001"]
    assert got.history == plain.history
    np.testing.assert_array_equal(got.frontier.encoded,
                                  plain.frontier.encoded)


@pytest.mark.parametrize("strategy", ["pt", "sweep"])
def test_host_fallback_refuses_checkpoint_dir(norm, strategy, tmp_path):
    """The host fallbacks refuse ``checkpoint_dir`` as the reference's
    do."""
    with pytest.raises(ValueError, match="device engine"):
        _pf(norm, device=False).search(
            _checkpointed(strategy, str(tmp_path / "x")), key=0)
