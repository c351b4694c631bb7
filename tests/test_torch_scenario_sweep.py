"""The port's scenario facades against a live run of the reference:
``ScenarioSweep.run`` on the 5 x 2 grid (the default five regions x
workloads 1 and 6) on the device path, its host fallback, the total
budget split across cells, ``ScenarioSpec``, ``Pathfinder.run_scenarios``
and ``workloads_from_configs`` (the ported dense, moe, hybrid and ssm
configs); ``shard=True`` on one device against the unsharded run.

Exact: best designs, frontier encodings, evaluation counts, error
messages. Within 1e-6 relative: best costs, histories, frontier
vectors. The ``cuda`` cases hold a 2-cell sweep on the card against the
same sweep on the CPU."""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.core import TEMPLATES, workload
from repro_torch.core.regions import Region, diurnal_profile
from repro_torch.pathfinding import (
    REGION_INTENSITIES,
    DesignSpace,
    Pathfinder,
    ScalarizationSweep,
    ScenarioSpec,
    ScenarioSweep,
    non_dominated_mask,
    workloads_from_configs,
)

RTOL = 1e-6
WL = workload(1)
CONFIGS = ["rwkv6-3b", "recurrentgemma-9b", "smollm-135m", "yi-6b",
           "qwen3-8b", "qwen2.5-14b", "deepseek-v2-236b",
           "llama4-maverick-400b-a17b"]
TWO = {"clean": 0.024, "dirty": 0.82}

REF = """
from repro.core import workload
from repro.pathfinding import DesignSpace, ScalarizationSweep, ScenarioSweep
from repro.pathfinding.pareto import workloads_from_configs

space = DesignSpace()


def save(tag, sf):
    for i, s in enumerate(sf.scenarios):
        r = sf.results[s.key]
        t = f"{tag}/{i}/"
        out[t + "key"] = np.array("|".join(s.key))
        out[t + "ci"] = np.array(s.carbon_intensity)
        out[t + "best_enc"] = space.encode(r.best)
        out[t + "best_cost"] = np.array(r.best_cost)
        out[t + "history"] = np.array(r.history)
        out[t + "evaluations"] = np.array(r.evaluations)
        out[t + "front_enc"] = r.frontier.encoded
        out[t + "front_vec"] = r.frontier.vectors
        out[t + "latency_s"] = np.array(r.best_metrics.latency_s)


wls = [workload(1), workload(6)]
grid = ScenarioSweep(
    strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=3),
    norm_samples=100)
save("grid", grid.run(wls, key=11))
two = ScenarioSweep(
    strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=3),
    regions=TWO, norm_samples=80)
save("host", two.run(workload(1), key=4, device=False))
budget = ScenarioSweep(
    strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=10),
    regions=TWO, norm_samples=80)
save("budget", budget.run(workload(1), budget=40, key=2))
for name, b in (("population", 7), ("per_cell", 1)):
    try:
        budget.run(workload(1), budget=b, key=2)
        out["refuse/" + name] = np.array("none")
    except Exception as e:
        out["refuse/" + name] = np.array(f"{type(e).__name__}: {e}")
for i, wl in enumerate(workloads_from_configs(CONFIGS, tokens=256)):
    out[f"cfg/{i}"] = np.array([wl.name, str(wl.M), str(wl.K), str(wl.N)])
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    consts = f"TWO = {TWO!r}\nCONFIGS = {CONFIGS!r}\n"
    return run_reference(consts + REF, None,
                         tmp_path_factory.mktemp("ref_scenario_sweep"))


def _sweep(sweeps=3, **kw):
    return ScenarioSweep(
        strategy=ScalarizationSweep(directions=2, n_chains=2, sweeps=sweeps),
        **kw)


@pytest.fixture(scope="module")
def grid():
    return _sweep(norm_samples=100).run([workload(1), workload(6)], key=11,
                                        torch_device="cpu")


def _same(sf, ref, tag):
    space = DesignSpace()
    assert len(sf.scenarios) == len({k.split("/")[1] for k in ref
                                     if k.startswith(tag + "/")})
    for i, s in enumerate(sf.scenarios):
        r, t = sf.results[s.key], f"{tag}/{i}/"
        assert "|".join(s.key) == str(ref[t + "key"])
        assert s.carbon_intensity == float(ref[t + "ci"])
        np.testing.assert_array_equal(space.encode(r.best),
                                      ref[t + "best_enc"])
        np.testing.assert_array_equal(r.frontier.encoded,
                                      ref[t + "front_enc"])
        assert r.evaluations == int(ref[t + "evaluations"])
        for got, key in ((r.best_cost, "best_cost"), (r.history, "history"),
                         (r.frontier.vectors, "front_vec"),
                         (r.best_metrics.latency_s, "latency_s")):
            got = np.asarray(got, dtype=np.float64)
            assert np.all(np.isfinite(got))
            np.testing.assert_allclose(got, ref[t + key], rtol=RTOL, atol=0)


def test_grid_5x2_matches_reference(ref, grid):
    assert len(grid.scenarios) == 10
    assert [s.region for s in grid.scenarios[:5]] == list(REGION_INTENSITIES)
    _same(grid, ref, "grid")


def test_grid_cells_differ_and_frontiers_are_non_dominated(grid):
    fronts = [grid.results[s.key].frontier.vectors for s in grid.scenarios]
    for f in fronts:
        assert len(f) >= 1 and non_dominated_mask(f).all()
    for i in range(len(fronts)):
        for j in range(i + 1, len(fronts)):
            assert not np.array_equal(fronts[i], fronts[j]), (i, j)


def test_grid_rerun_is_bit_equal_and_another_key_moves_it(grid):
    again = _sweep(norm_samples=100).run([workload(1), workload(6)], key=11,
                                         torch_device="cpu")
    other = _sweep(norm_samples=100).run([workload(1), workload(6)], key=12,
                                         torch_device="cpu")
    for s in grid.scenarios:
        a, b = grid.results[s.key], again.results[s.key]
        np.testing.assert_array_equal(a.frontier.vectors, b.frontier.vectors)
        assert a.best_cost == b.best_cost and a.history == b.history
    assert any(not np.array_equal(grid.results[s.key].frontier.vectors,
                                  other.results[s.key].frontier.vectors)
               for s in grid.scenarios)


def test_segmented_grid_is_bit_equal(grid):
    seg = _sweep(norm_samples=100).run([workload(1), workload(6)], key=11,
                                       segment=2, torch_device="cpu")
    for s in grid.scenarios:
        a, b = grid.results[s.key], seg.results[s.key]
        np.testing.assert_array_equal(a.frontier.encoded, b.frontier.encoded)
        np.testing.assert_array_equal(a.frontier.vectors, b.frontier.vectors)
        assert a.history == b.history


def test_host_fallback_matches_reference(ref):
    sf = _sweep(regions=TWO, norm_samples=80).run(
        WL, key=4, device=False, torch_device="cpu")
    _same(sf, ref, "host")


def test_budget_is_split_across_cells(ref):
    sweep = _sweep(sweeps=10, regions=TWO, norm_samples=80)
    sf = sweep.run(WL, budget=40, key=2, torch_device="cpu")
    assert [sf.results[s.key].evaluations for s in sf.scenarios] == [20, 20]
    _same(sf, ref, "budget")


@pytest.mark.parametrize("name,budget", [("population", 7), ("per_cell", 1)])
def test_budget_refusals_match_reference(ref, name, budget):
    sweep = _sweep(sweeps=10, regions=TWO, norm_samples=80)
    want = str(ref["refuse/" + name])
    assert want.startswith("ValueError: ")
    with pytest.raises(ValueError) as exc:
        sweep.run(WL, budget=budget, key=2, torch_device="cpu")
    assert f"ValueError: {exc.value}" == want


def test_workloads_from_configs_match_reference(ref):
    got = workloads_from_configs(CONFIGS, tokens=256)
    for i, wl in enumerate(got):
        assert [wl.name, str(wl.M), str(wl.K), str(wl.N)] == \
            ref[f"cfg/{i}"].tolist()
    assert [wl.name for wl in got[2:]] == [
        "smollm-135m-mlp256", "yi-6b-mlp256", "qwen3-8b-mlp256",
        "qwen2.5-14b-mlp256", "deepseek-v2-236b-mlp256",
        "llama4-maverick-400b-a17b-mlp256"]
    # the moe configs' d_ff is the per-expert width, as in the reference
    assert [(wl.K, wl.N) for wl in got[6:]] == [(5120, 1536), (5120, 8192)]
    # the vlm and audio configs resolve too, to their own MLP GEMMs
    assert [(wl.name, wl.M, wl.K, wl.N) for wl in workloads_from_configs(
        ["internvl2-26b", "hubert-xlarge"], tokens=256)] == [
        ("internvl2-26b-mlp256", 256, 6144, 16384),
        ("hubert-xlarge-mlp256", 256, 1280, 5120)]


# ---------------------------------------------------------------------------
# ScenarioSpec
# ---------------------------------------------------------------------------


def test_spec_normalizes_and_hashes():
    spec = ScenarioSpec(workloads=WL, regions={"a": 0.1, "b": Region(0.5)})
    assert spec.workloads == (WL,)
    assert all(isinstance(r, Region) for _, r in spec.regions)
    again = ScenarioSpec(workloads=(WL,),
                         regions=(("a", Region(0.1)), ("b", Region(0.5))))
    assert spec == again and hash(spec) == hash(again)
    assert list(spec.region_map()) == ["a", "b"]
    assert spec.region_map()["b"].carbon_intensity == 0.5


@pytest.mark.parametrize("kw,match", [
    (dict(comm="torus"), "unknown comm model"),
    (dict(schedule="nightly"), "unknown schedule model"),
    (dict(regions={}), "1 region"),
    (dict(workloads=()), "GEMMWorkload")])
def test_spec_validation(kw, match):
    args = dict(workloads=WL, regions={"a": 0.1})
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ScenarioSpec(**args)


def test_spec_rejects_loose_kwargs_alongside():
    spec = ScenarioSpec(workloads=WL, regions={"a": 0.1}, budget=100)
    with pytest.raises(ValueError, match="ride inside"):
        ScenarioSweep().run(spec, budget=50, torch_device="cpu")
    pf = Pathfinder(WL, TEMPLATES["T1"], torch_device="cpu")
    with pytest.raises(ValueError, match="already carries"):
        pf.run_scenarios(spec, budget=50)
    with pytest.raises(ValueError, match="already carries"):
        pf.run_scenarios(spec, regions={"a": 0.1})


def test_spec_replays_loose_regions_bits():
    """The deprecated ``run_scenarios(regions=...)`` spelling warns and
    gives the bits of the equivalent ScenarioSpec."""
    strat = ScalarizationSweep(directions=2, n_chains=2, sweeps=10)
    pf = Pathfinder(WL, TEMPLATES["T1"], torch_device="cpu")
    with pytest.warns(DeprecationWarning, match="run_scenarios"):
        loose = pf.run_scenarios(ScenarioSweep(strategy=strat),
                                 regions={"a": 0.1, "b": 0.7}, budget=200,
                                 key=5)
    spec = ScenarioSpec(workloads=(WL,), regions={"a": 0.1, "b": 0.7},
                        budget=200)
    via_spec = ScenarioSweep(strategy=strat).run(spec, key=5,
                                                 torch_device="cpu")
    for s in loose.scenarios:
        a, b = loose.results[s.key], via_spec.results[s.key]
        assert a.best_cost == b.best_cost and a.best == b.best
        assert np.array_equal(np.asarray(a.history), np.asarray(b.history))


# ---------------------------------------------------------------------------
# run_scenarios, checkpoint_dir and shard
# ---------------------------------------------------------------------------


def test_run_scenarios_facade():
    pf = Pathfinder(WL, TEMPLATES["T1"], torch_device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sf = pf.run_scenarios(
            sweep=dataclasses.replace(_sweep(sweeps=2, norm_samples=80),
                                      regions=TWO), key=4)
    assert len(sf.scenarios) == 2
    assert {s.region for s in sf.scenarios} == set(TWO)
    merged = sf.merged(WL.name)
    assert len(merged) >= 1 and non_dominated_mask(merged.vectors).all()
    rows = list(sf.rows())
    assert len(rows) == sum(len(sf.results[s.key].frontier)
                            for s in sf.scenarios)
    with pytest.raises(ValueError, match="carbonpath"):
        Pathfinder(WL, objective="chipletgym",
                   torch_device="cpu").run_scenarios()


def test_device_checkpoint_dir_snapshots_and_equals_plain_run(tmp_path):
    """The device path checkpoints (a snapshot per boundary) and returns
    what the plain run returns."""
    ckpt = str(tmp_path / "ckpt")
    sweep = _sweep(regions=TWO, norm_samples=80)
    got = sweep.run(WL, key=1, torch_device="cpu", segment=2,
                    checkpoint_dir=ckpt)
    plain = sweep.run(WL, key=1, torch_device="cpu")
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    for s in plain.scenarios:
        assert got.results[s.key].history == plain.results[s.key].history
        np.testing.assert_array_equal(got.results[s.key].frontier.encoded,
                                      plain.results[s.key].frontier.encoded)


def test_host_fallback_refuses_checkpoint_dir(tmp_path):
    """The host fallback refuses ``checkpoint_dir`` as the reference's
    does."""
    with pytest.raises(ValueError, match="device path"):
        _sweep(regions=TWO, norm_samples=80).run(
            WL, key=1, torch_device="cpu", device=False,
            checkpoint_dir=str(tmp_path / "ckpt"))


def test_shard_true_on_one_device_equals_unsharded():
    """``shard=True`` runs the cells on the one-device mesh of the run's
    device (here the CPU) and gives bit for bit what ``shard=False``
    and ``"auto"`` give."""
    runs = {shard: _sweep(regions=TWO, norm_samples=80, shard=shard).run(
        [WL, workload(6)], key=1, torch_device="cpu")
        for shard in (True, False, "auto")}
    plain = runs[False]
    for shard in (True, "auto"):
        for s in plain.scenarios:
            got, want = runs[shard].results[s.key], plain.results[s.key]
            assert got.best_cost == want.best_cost and got.best == want.best
            assert got.history == want.history
            np.testing.assert_array_equal(got.frontier.encoded,
                                          want.frontier.encoded)
            np.testing.assert_array_equal(got.frontier.vectors,
                                          want.frontier.vectors)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_grid(torch_device):
    regions = {
        "a": Region(0.3, electricity_price=0.1, emb_factor=1.2,
                    grid_profile=diurnal_profile(0.3),
                    price_profile=diurnal_profile(0.1, peak_hour=12)),
        "b": 0.7}
    return _sweep(regions=regions, norm_samples=80, comm="mesh_noc",
                  schedule="window").run(WL, key=3,
                                         torch_device=torch_device)


@pytest.mark.cuda
def test_two_cell_sweep_on_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.prefix_gather import launch_count

    before = launch_count()
    gpu = _card_grid("cuda")
    assert launch_count() - before == 1 + 3 + 1
    cpu = _card_grid("cpu")
    space = DesignSpace(comm="mesh_noc", schedule="window")
    for s in cpu.scenarios:
        a, b = gpu.results[s.key], cpu.results[s.key]
        np.testing.assert_array_equal(space.encode(a.best),
                                      space.encode(b.best))
        np.testing.assert_array_equal(a.frontier.encoded, b.frontier.encoded)
        np.testing.assert_allclose(a.frontier.vectors, b.frontier.vectors,
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(a.history, b.history, rtol=RTOL, atol=0)
        np.testing.assert_allclose(a.best_cost, b.best_cost, rtol=RTOL,
                                   atol=0)
