"""The port's stacked scenario engine and its pieces against a live run of
the reference: the batched threefry keys, ``fold_cell_key``,
``fit_region_normalizers``, ``ScenarioEngine.evaluate_cost`` (against
the reference's plain path and its interpret-mode Pallas path),
``ScenarioEngine.parallel_tempering`` (whole, segmented, through
``segment_runner`` with per-cell sweep counters, on a mesh-NoC + window
space with per-cell move gates, and on a one-device scenario mesh), one
``prefix_select`` call and the same torch ops a sweep whatever the
number of cells, and the refusals.

Exact: key words, draws, ``fold_cell_key``, encodings, samples, error
messages. Within 1e-6 relative: costs, histories and vectors (float64 on
both sides; reductions may sum in another order). Within 1e-9 relative:
the region normalizers."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_support import run_reference

import repro_torch.pathfinding.device as device_mod
from repro_torch import random as trandom
from repro_torch.core import workload
from repro_torch.core.regions import Region, diurnal_profile
from repro_torch.core.techdb import DEFAULT_DB
from repro_torch.pathfinding import (
    DesignSpace,
    ParetoArchive,
    ScenarioEngine,
    fit_normalizer_batched,
    fit_region_normalizers,
    fold_cell_key,
)

RTOL = 1e-6
NORM_RTOL = 1e-9
SEEDS = [0, 3, 7, 0x9E3779B9, 2 ** 40 + 17]
UNI_SHAPES = [(5, 3), (37,)]
FOLD_PAIRS = [(0, 0), (0, 3), (7, 3), (11, 9), (0x9E3779B9, 4),
              (2 ** 40 + 3, 2), (-5, 1), (12345, 1000)]
REG = dict(carbon_intensity=0.3, electricity_price=0.12, emb_factor=1.3,
           grid_profile=diurnal_profile(0.3, swing=0.4),
           price_profile=diurnal_profile(0.12, swing=0.25, peak_hour=18))
S, N, NSW, SWAP, SEED = 4, 6, 6, 2, 5
SWEEP0 = np.array([0, 1, 2, 3], dtype=np.int64)
NOC_ON = np.array([1.0, 0.0, 1.0, 0.0])
SCHED_ON = np.array([1.0, 1.0, 0.0, 0.0])
EV_S, EV_M = 3, 10
REFUSALS = ("rank", "segment", "archives", "widx", "noc_on", "sched_on",
            "ckpt_samples")

REF = """
import jax.numpy as jnp
from repro.core import workload
from repro.core.regions import Region
from repro.pathfinding import (DesignSpace, ScenarioEngine,
                               fit_region_normalizers, fold_cell_key)
from repro.pathfinding.pareto import ParetoArchive

with jax.enable_x64(True):
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in SEEDS])
    out["rng/split"] = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    out["rng/fold"] = jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys)
    for j, shp in enumerate(UNI_SHAPES):
        out[f"rng/uni{j}"] = jax.vmap(lambda k: jax.random.uniform(
            k, shp, dtype=jnp.float64))(keys)
    out["rng/foldrange"] = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(11), i))(jnp.arange(6))
out["foldkey"] = np.array([fold_cell_key(b, i) for b, i in FOLD_PAIRS],
                          dtype=np.int64)

wl1 = workload(1)
regions = [0.024, 0.475, Region(**REG)]
for tag, sp in (("fixed", DesignSpace()),
                ("window", DesignSpace(schedule="window"))):
    fitted = fit_region_normalizers(wl1, regions, samples=120, seed=9,
                                    space=sp)
    out[f"norm/{tag}/mins"] = np.stack([nz.weights_arrays()[0]
                                        for nz in fitted])
    out[f"norm/{tag}/med"] = np.stack([nz.weights_arrays()[1]
                                       for nz in fitted])

wls = (workload(1), workload(6))
eng = ScenarioEngine(wls, space=DesignSpace(), use_pallas=False)
engp = ScenarioEngine(wls, space=DesignSpace(), use_pallas=True)
for tag, e in (("plain", eng), ("pallas", engp)):
    args = [inp["ev_" + k] for k in ("enc", "mins", "med", "w", "ci",
                                     "widx")]
    c, v = e.evaluate_cost(*args, price=inp["ev_price"],
                           embf=inp["ev_embf"], profile=inp["ev_profile"],
                           pprofile=inp["ev_pprofile"])
    out[f"ev/{tag}/cost"], out[f"ev/{tag}/vec"] = c, v
    c, v = e.evaluate_cost(*args)
    out[f"ev/{tag}/cost_n"], out[f"ev/{tag}/vec_n"] = c, v

region = dict(price=inp["price"], embf=inp["embf"], profile=inp["profile"],
              pprofile=inp["pprofile"])
kw = dict(mins=inp["mins"], medians=inp["med"], weights=inp["w"],
          pair_mask=inp["pair"], ci=inp["ci"], widx=inp["widx"], **region)


def save(tag, r):
    out[tag + "best_enc"], out[tag + "best_cost"] = r.best_enc, r.best_cost
    out[tag + "history"], out[tag + "evaluations"] = (r.history,
                                                      np.array(r.evaluations))
    out[tag + "final_enc"], out[tag + "final_costs"] = (r.final_enc,
                                                        r.final_costs)
    out[tag + "samples_enc"] = r.samples["enc"]
    out[tag + "samples_vec"] = r.samples["vec"]


save("pt/", eng.parallel_tempering(inp["v0"], inp["temps"], NSW, SWAP,
                                   seed=SEED, **kw))
sp2 = DesignSpace(comm="mesh_noc", schedule="window")
eng2 = ScenarioEngine(wls, space=sp2, use_pallas=False)
save("gates/", eng2.parallel_tempering(
    inp["v0m"], inp["temps"], NSW, SWAP, seed=SEED, noc_on=NOC_ON,
    sched_on=SCHED_ON, **kw))

with jax.enable_x64(True):
    Sc, n = inp["v0"].shape[:2]
    price, embf, profile, pprofile = eng._region_cols(Sc, inp["ci"],
                                                      **region)
    args = [jnp.asarray(x) for x in (
        inp["temps"], inp["mins"], inp["med"], inp["w"], inp["pair"],
        inp["ci"], price, embf, profile, pprofile,
        inp["widx"].astype(np.int32))]
    v0 = jnp.asarray(inp["v0"].astype(np.int32))
    keys0, cost0, _ = eng._init_fn(Sc, n)(
        v0, *args[1:4], *args[5:], jax.random.PRNGKey(SEED))
    bi = jnp.argmin(cost0, axis=1)
    best_v0 = jnp.take_along_axis(v0, bi[:, None, None], axis=1)[:, 0]
    best_c0 = jnp.take_along_axis(cost0, bi[:, None], axis=1)[:, 0]
    out["init/keys"], out["init/cost"] = keys0, cost0
    out["init/best_v"], out["init/best_c"] = best_v0, best_c0
    fn = eng.segment_runner(Sc, n, NSW, SWAP, True)
    carry, ys = fn(v0, cost0, best_v0, best_c0, keys0,
                   jnp.asarray(SWEEP0), *args)
    for name, x in zip(("v", "costs", "best_v", "best_c", "keys"), carry):
        out["run/carry/" + name] = x
    for name, x in zip(("cold", "best", "prop", "vec"), ys):
        out["run/ys/" + name] = x

bad = dict(rank=dict(v0=inp["v0"][0]), segment=dict(segment=0),
           archives=dict(archives=[ParetoArchive()] * (Sc - 1)),
           widx=dict(widx=np.array([0, 1, 2, 0])),
           noc_on=dict(noc_on=np.ones(Sc)), sched_on=dict(sched_on=np.ones(Sc)),
           ckpt_samples=dict(checkpoint=object()))
for name in REFUSALS:
    call = dict(kw, v0=inp["v0"], temps=inp["temps"], sweeps=1,
                swap_every=SWAP, seed=SEED)
    call.update(bad[name])
    try:
        eng.parallel_tempering(**call)
        out["refuse/" + name] = np.array("none")
    except Exception as e:
        out["refuse/" + name] = np.array(f"{type(e).__name__}: {e}")
out = {k: np.asarray(v) for k, v in out.items()}
"""

CONSTS = (f"SEEDS = {SEEDS!r}\nUNI_SHAPES = {UNI_SHAPES!r}\n"
          f"FOLD_PAIRS = {FOLD_PAIRS!r}\nREG = {REG!r}\n"
          f"NSW = {NSW}\nSWAP = {SWAP}\nSEED = {SEED}\n"
          f"SWEEP0 = np.array({SWEEP0.tolist()!r}, dtype=np.int64)\n"
          f"NOC_ON = np.array({NOC_ON.tolist()!r})\n"
          f"SCHED_ON = np.array({SCHED_ON.tolist()!r})\n"
          f"REFUSALS = {REFUSALS!r}\n")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    sp, sp2 = DesignSpace(), DesignSpace(comm="mesh_noc",
                                         schedule="window")
    ladder = 5.0 * (0.01 ** (np.arange(N) / (N - 1)))
    pair = rng.random((S, N - 1)) < 0.7
    pair[:, 2] = False                         # a gap in every ladder
    pair[1] = True                             # one ladder without gaps
    ci = np.array([0.024, 0.475, 0.82, 0.3])
    price = np.array([0.0, 0.1, 0.0, 0.07])
    flat = np.repeat(ci[:, None], 24, axis=1)
    profile = flat.copy()
    profile[1] = diurnal_profile(0.475, swing=0.3)
    profile[3] = diurnal_profile(0.3, swing=0.5, peak_hour=7)
    pprofile = np.repeat(price[:, None], 24, axis=1)
    pprofile[3] = diurnal_profile(0.07, swing=0.4)
    ev_ci = np.array([0.1, 0.5, 0.9])
    return dict(
        v0=np.stack([sp.sample(N, key=40 + s) for s in range(S)]),
        v0m=np.stack([sp2.sample(N, key=60 + s) for s in range(S)]),
        temps=np.tile(ladder, (S, 1)),
        mins=rng.random((S, 6)) * 0.1,
        med=1.0 + rng.random((S, 6)),
        w=np.round(rng.random((S, N, 6)) * 4) / 4,
        pair=pair, ci=ci, widx=np.array([0, 1, 0, 1]),
        price=price, embf=np.array([1.0, 1.0, 1.2, 0.8]),
        profile=profile, pprofile=pprofile,
        ev_enc=np.stack([sp.sample(EV_M, key=80 + s) for s in range(EV_S)]),
        ev_mins=rng.random((EV_S, 6)) * 0.1,
        ev_med=1.0 + rng.random((EV_S, 6)),
        ev_w=rng.random((EV_S, 6)), ev_ci=ev_ci,
        ev_widx=np.array([0, 1, 1]), ev_price=np.array([0.0, 0.1, 0.05]),
        ev_embf=np.array([1.0, 1.2, 0.9]),
        ev_profile=np.stack([diurnal_profile(c, swing=0.2 + 0.1 * i)
                             for i, c in enumerate(ev_ci)]),
        ev_pprofile=np.stack([diurnal_profile(p + 0.01, swing=0.3)
                              for p in (0.0, 0.1, 0.05)]))


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    return run_reference(CONSTS + REF, inputs,
                         tmp_path_factory.mktemp("ref_scenario"))


@pytest.fixture(scope="module")
def engine():
    return ScenarioEngine((workload(1), workload(6)), space=DesignSpace(),
                          torch_device="cpu")


def _kw(inputs):
    return dict(mins=inputs["mins"], medians=inputs["med"],
                weights=inputs["w"], pair_mask=inputs["pair"],
                ci=inputs["ci"], widx=inputs["widx"],
                price=inputs["price"], embf=inputs["embf"],
                profile=inputs["profile"], pprofile=inputs["pprofile"])


@pytest.fixture(scope="module")
def pt(engine, inputs):
    return engine.parallel_tempering(inputs["v0"], inputs["temps"], NSW,
                                     SWAP, seed=SEED, **_kw(inputs))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _keys():
    return torch.stack([trandom.PRNGKey(s) for s in SEEDS])


# ---------------------------------------------------------------------------
# batched threefry keys and fold_cell_key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["split", "fold", "uni0", "uni1",
                                  "foldrange"])
def test_batched_rng_bit_equal_to_vmap(ref, what):
    keys = _keys()
    got = {"split": lambda: trandom.split(keys, 4),
           "fold": lambda: trandom.fold_in(keys, 7),
           "uni0": lambda: trandom.uniform(keys, UNI_SHAPES[0]),
           "uni1": lambda: trandom.uniform(keys, UNI_SHAPES[1]),
           "foldrange": lambda: trandom.fold_in(trandom.PRNGKey(11),
                                                torch.arange(6))}[what]()
    want = ref["rng/" + what]
    if want.dtype != np.float64:
        want = want.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("what", ["split", "fold", "uni0", "uni1"])
def test_batched_rng_rows_equal_single_key_forms(what):
    keys = _keys()
    call = {"split": lambda k: trandom.split(k, 4),
            "fold": lambda k: trandom.fold_in(k, 7),
            "uni0": lambda k: trandom.uniform(k, UNI_SHAPES[0]),
            "uni1": lambda k: trandom.uniform(k, UNI_SHAPES[1])}[what]
    batched = call(keys)
    for s in range(len(SEEDS)):
        assert torch.equal(batched[s], call(keys[s]))


def test_uniform_cells_is_the_per_key_draws_side_by_side():
    keys = _keys()
    got = trandom.uniform_cells(keys, 7, 3)
    want = torch.cat([trandom.uniform(k, (7, 3)) for k in keys], dim=1)
    assert got.shape == (7, 3 * len(SEEDS)) and torch.equal(got, want)


def test_fold_cell_key_bit_equal(ref):
    got = [fold_cell_key(b, i) for b, i in FOLD_PAIRS]
    assert got == ref["foldkey"].tolist()
    assert all(0 <= k < 2 ** 63 for k in got)


# ---------------------------------------------------------------------------
# fit_region_normalizers
# ---------------------------------------------------------------------------


def _regions():
    return [0.024, 0.475, Region(**REG)]


@pytest.mark.parametrize("tag", ["fixed", "window"])
def test_region_normalizers_match_reference(ref, tag):
    sp = DesignSpace() if tag == "fixed" else DesignSpace(schedule="window")
    fitted = fit_region_normalizers(workload(1), _regions(), samples=120,
                                    seed=9, space=sp, torch_device="cpu")
    _close(np.stack([nz.weights_arrays()[0] for nz in fitted]),
           ref[f"norm/{tag}/mins"], NORM_RTOL)
    _close(np.stack([nz.weights_arrays()[1] for nz in fitted]),
           ref[f"norm/{tag}/med"], NORM_RTOL)


@pytest.mark.parametrize("tag", ["fixed", "window"])
def test_region_normalizers_bit_identical_to_per_region_fits(tag):
    import dataclasses

    kw = {} if tag == "fixed" else dict(schedule="window")
    fitted = fit_region_normalizers(workload(1), _regions(), samples=120,
                                    seed=9, space=DesignSpace(**kw),
                                    torch_device="cpu")
    for spec, nz in zip(_regions(), fitted):
        reg = spec if isinstance(spec, Region) else Region(spec)
        db_s = dataclasses.replace(DEFAULT_DB, **reg.db_overrides())
        want = fit_normalizer_batched(workload(1), db_s, samples=120, seed=9,
                                      space=DesignSpace(db_s, **kw),
                                      torch_device="cpu")
        assert nz.mins == want.mins and nz.medians == want.medians


# ---------------------------------------------------------------------------
# ScenarioEngine.evaluate_cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["plain", "pallas"])
@pytest.mark.parametrize("axes", ["regional", "neutral"])
def test_evaluate_cost_matches_reference(ref, engine, inputs, path, axes):
    args = [inputs["ev_" + k] for k in ("enc", "mins", "med", "w", "ci",
                                         "widx")]
    kw = {} if axes == "neutral" else dict(
        price=inputs["ev_price"], embf=inputs["ev_embf"],
        profile=inputs["ev_profile"], pprofile=inputs["ev_pprofile"])
    cost, vec = engine.evaluate_cost(*args, **kw)
    tail = "_n" if axes == "neutral" else ""
    assert cost.shape == (EV_S, EV_M) and vec.shape == (EV_S, EV_M, 3)
    _close(cost, ref[f"ev/{path}/cost{tail}"])
    _close(vec, ref[f"ev/{path}/vec{tail}"])


# ---------------------------------------------------------------------------
# ScenarioEngine.parallel_tempering
# ---------------------------------------------------------------------------


def _same_run(r, ref, tag):
    np.testing.assert_array_equal(r.best_enc, ref[tag + "best_enc"])
    np.testing.assert_array_equal(r.final_enc, ref[tag + "final_enc"])
    np.testing.assert_array_equal(r.samples["enc"], ref[tag + "samples_enc"])
    assert r.evaluations == int(ref[tag + "evaluations"]) == S * N * (1 + NSW)
    _close(r.best_cost, ref[tag + "best_cost"])
    _close(r.history, ref[tag + "history"])
    _close(r.final_costs, ref[tag + "final_costs"])
    _close(r.samples["vec"], ref[tag + "samples_vec"])


def test_parallel_tempering_matches_reference(ref, pt):
    assert pt.history.shape == (S, 1 + NSW)
    assert pt.samples["enc"].shape == (1 + NSW, S, N, DesignSpace().width)
    _same_run(pt, ref, "pt/")


def test_segmented_run_is_bit_equal(engine, inputs, pt):
    seg = engine.parallel_tempering(inputs["v0"], inputs["temps"], NSW, SWAP,
                                    seed=SEED, segment=2, **_kw(inputs))
    for f in ("best_enc", "best_cost", "history", "final_enc",
              "final_costs"):
        np.testing.assert_array_equal(getattr(seg, f), getattr(pt, f))
    for f in ("enc", "vec"):
        np.testing.assert_array_equal(seg.samples[f], pt.samples[f])


def test_archives_are_fed_per_cell(engine, inputs, pt):
    archives = [ParetoArchive(max_size=64) for _ in range(S)]
    res = engine.parallel_tempering(inputs["v0"], inputs["temps"], NSW, SWAP,
                                    seed=SEED, segment=4, archives=archives,
                                    **_kw(inputs))
    assert res.samples is None
    np.testing.assert_array_equal(res.history, pt.history)
    for s in range(S):
        want = ParetoArchive(max_size=64)
        want.insert(pt.samples["enc"][:, s].reshape(-1, pt.final_enc.shape[-1]),
                    pt.samples["vec"][:, s].reshape(-1, 3))
        np.testing.assert_array_equal(archives[s].encoded, want.encoded)
        np.testing.assert_array_equal(archives[s].vectors, want.vectors)


def test_segment_runner_with_per_cell_sweep_counters(ref, engine, inputs):
    """Cells at different sweep counters swap at different sweeps; the
    runner takes the reference's positional arguments and returns its
    (carry, ys)."""
    price, embf, profile, pprofile = engine._region_cols(
        S, inputs["ci"], inputs["price"], inputs["embf"], inputs["profile"],
        inputs["pprofile"])
    run = engine.segment_runner(S, N, NSW, SWAP, collect_samples=True)
    carry, ys = run(inputs["v0"], ref["init/cost"], ref["init/best_v"],
                    ref["init/best_c"], ref["init/keys"].astype(np.int64),
                    SWEEP0, inputs["temps"], inputs["mins"], inputs["med"],
                    inputs["w"], inputs["pair"], inputs["ci"], price, embf,
                    profile, pprofile, inputs["widx"])
    assert len(carry) == 5 and len(ys) == 4
    for name, x in zip(("v", "best_v", "keys"), (carry[0], carry[2],
                                                 carry[4])):
        np.testing.assert_array_equal(
            x.numpy(), ref["run/carry/" + name].astype(np.int64))
    np.testing.assert_array_equal(ys[2].numpy(),
                                  ref["run/ys/prop"].astype(np.int64))
    _close(carry[1].numpy(), ref["run/carry/costs"])
    _close(carry[3].numpy(), ref["run/carry/best_c"])
    for i, name in ((0, "cold"), (1, "best"), (3, "vec")):
        _close(ys[i].numpy(), ref["run/ys/" + name])


def test_per_cell_move_gates_on_mesh_window_space(ref, inputs):
    sp2 = DesignSpace(comm="mesh_noc", schedule="window")
    eng2 = ScenarioEngine((workload(1), workload(6)), space=sp2,
                          torch_device="cpu")
    r = eng2.parallel_tempering(inputs["v0m"], inputs["temps"], NSW, SWAP,
                                seed=SEED, noc_on=NOC_ON, sched_on=SCHED_ON,
                                **_kw(inputs))
    _same_run(r, ref, "gates/")


# ---------------------------------------------------------------------------
# S does not set the work a sweep issues
# ---------------------------------------------------------------------------


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _grid_run(engine, inputs, cells, sweeps):
    take = np.arange(cells) % S
    kw = {k: v[take] for k, v in _kw(inputs).items()}
    return engine.parallel_tempering(inputs["v0"][take],
                                     inputs["temps"][take], sweeps, SWAP,
                                     seed=SEED, **kw)


def test_one_prefix_select_call_a_sweep_whatever_s(engine, inputs,
                                                   monkeypatch):
    calls = []
    real = device_mod.prefix_select

    def counted(*args):
        calls.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(device_mod, "prefix_select", counted)
    counts = {}
    for cells in (1, 5):
        calls.clear()
        _grid_run(engine, inputs, cells, 3)
        counts[cells] = list(calls)
    assert len(counts[1]) == len(counts[5]) == 1 + 3
    assert set(counts[1]) == {N} and set(counts[5]) == {5 * N}


def test_torch_ops_a_run_do_not_grow_with_s(engine, inputs):
    ops = {}
    for cells in (1, 5):
        with _OpCount() as mode:
            _grid_run(engine, inputs, cells, 3)
        ops[cells] = mode.n
    assert ops[1] == ops[5] > 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_reference(ref, engine, inputs, name):
    bad = dict(rank=dict(v0=inputs["v0"][0]), segment=dict(segment=0),
               archives=dict(archives=[ParetoArchive()] * (S - 1)),
               widx=dict(widx=np.array([0, 1, 2, 0])),
               noc_on=dict(noc_on=np.ones(S)),
               sched_on=dict(sched_on=np.ones(S)),
               ckpt_samples=dict(checkpoint=object()))[name]
    call = dict(_kw(inputs), v0=inputs["v0"], temps=inputs["temps"],
                sweeps=1, swap_every=SWAP, seed=SEED)
    call.update(bad)
    want = str(ref["refuse/" + name])
    assert want.startswith("ValueError: ")
    with pytest.raises(ValueError) as exc:
        engine.parallel_tempering(**call)
    assert f"ValueError: {exc.value}" == want


@pytest.mark.parametrize("kw", [
    dict(checkpoint=True, archives=None),
    dict(checkpoint=True, collect_samples=False)],
    ids=["checkpoint", "checkpoint_nosamples"])
def test_checkpointed_run_returns_the_plain_run(engine, inputs, kw,
                                                tmp_path):
    """A checkpointed run (with per-cell archives, or without samples)
    leaves a snapshot and returns what the plain run returns."""
    from repro_torch.pathfinding import SearchCheckpointer

    kw = dict(kw, checkpoint=SearchCheckpointer(str(tmp_path)))
    if "archives" in kw:
        kw["archives"] = [ParetoArchive() for _ in range(S)]
    got = engine.parallel_tempering(inputs["v0"], inputs["temps"], 2, SWAP,
                                    seed=SEED, **_kw(inputs), **kw)
    plain = engine.parallel_tempering(
        inputs["v0"], inputs["temps"], 2, SWAP, seed=SEED, **_kw(inputs),
        collect_samples=kw.get("collect_samples", True))
    assert kw["checkpoint"].manager.all_steps() == [2]
    np.testing.assert_array_equal(got.history, plain.history)
    np.testing.assert_array_equal(got.final_enc, plain.final_enc)


def test_one_device_mesh_equals_no_mesh(engine, inputs):
    """``mesh=scenario_mesh(1, "cpu")`` places the cells' arrays on the
    one device: the run is bit for bit the one without a mesh."""
    from repro_torch.distributed import scenario_mesh

    mesh = scenario_mesh(1, "cpu")
    assert mesh == (torch.device("cpu"),)
    got, plain = (engine.parallel_tempering(
        inputs["v0"], inputs["temps"], 3, SWAP, seed=SEED, **_kw(inputs),
        mesh=m) for m in (mesh, None))
    for name in ("history", "final_enc", "final_costs", "best_enc",
                 "best_cost"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(plain, name))
    np.testing.assert_array_equal(got.samples["enc"], plain.samples["enc"])
    np.testing.assert_array_equal(got.samples["vec"], plain.samples["vec"])


def test_mesh_of_two_devices_is_not_ported(engine, inputs):
    """A tuple of two local devices (a run without a process group) is
    refused: only a DeviceMesh over a process group splits the cells.
    Ranks that do not divide the cells each run the whole grid, bit for
    bit as ``mesh=None`` (the split over ranks that divide them is held
    in ``tests/test_torch_distributed.py``); a mesh on another device
    type than the engine's is refused."""
    class ThreeRanks:           # rank 1 of 3 on the CPU, no group needed
        device_type = "cpu"
        mesh_dim_names = ("data",)

        def get_local_rank(self):
            return 1

        def size(self):
            return 3

    S = inputs["v0"].shape[0]
    assert S % 3
    two = (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError, match="split only over the ranks"):
        engine.parallel_tempering(inputs["v0"], inputs["temps"], 1, SWAP,
                                  seed=SEED, **_kw(inputs), mesh=two)
    plain = engine.parallel_tempering(inputs["v0"], inputs["temps"], 2, SWAP,
                                      seed=SEED, **_kw(inputs))
    got = engine.parallel_tempering(inputs["v0"], inputs["temps"], 2, SWAP,
                                    seed=SEED, **_kw(inputs),
                                    mesh=ThreeRanks())
    for name in ("history", "final_enc", "final_costs", "best_enc",
                 "best_cost"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(plain, name))
    with pytest.raises(ValueError, match="not on this engine's device"):
        engine.parallel_tempering(inputs["v0"], inputs["temps"], 1, SWAP,
                                  seed=SEED, **_kw(inputs),
                                  mesh=(torch.device("cuda", 0),))


def test_engine_refuses_no_workloads_and_bad_widx(engine, inputs):
    with pytest.raises(ValueError, match=">= 1 workload"):
        ScenarioEngine((), torch_device="cpu")
    with pytest.raises(ValueError, match="widx out of range"):
        engine.evaluate_cost(inputs["ev_enc"], inputs["ev_mins"],
                             inputs["ev_med"], inputs["ev_w"],
                             inputs["ev_ci"], np.array([0, 2, 1]))
