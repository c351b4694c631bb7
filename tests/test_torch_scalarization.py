"""The port's multi-objective sweep against a live run of the reference:
``simplex_directions``, ``directions_to_weights``, ``ScalarizationSweep``
on the device engine and on the host fallback, and the tempering
engine's per-chain ``weights``, replica-exchange ``pair_mask`` and
``record_trace``.

Exact: directions, weight rows, encodings, evaluation counts, every
proposal, acceptance and uniform draw. Within 1e-6 relative: costs,
histories and frontier vectors (float64 on both sides, reductions may
sum in another order); within 1e-9 the traced costs and the host replay
of a trace through the scalar evaluator."""
import math

import numpy as np
import pytest

from test_torch_support import run_reference

from repro_torch.convert import normalizer_from_arrays
from repro_torch.core import TEMPLATES, evaluate, fit_normalizer, workload
from repro_torch.core.scalesim import SimCache
from repro_torch.core.templates import Template, sa_cost
from repro_torch.pathfinding import (
    DesignSpace,
    ParetoArchive,
    Pathfinder,
    ScalarizationSweep,
    directions_to_weights,
    get_device_evaluator,
    simplex_directions,
)

RTOL = 1e-6
TRACE_RTOL = 1e-9
SWEEP = dict(directions=3, n_chains=2, sweeps=4)
N, SWEEPS, SWAP = 8, 10, 2
MASK = np.array([1, 1, 0, 1, 1, 0, 1], dtype=bool)
TRACE_FIELDS = ("proposals", "proposal_costs", "u_accept", "u_swap",
                "accepted", "costs", "best_per_sweep", "initial_costs")

REF = """
from repro.core import TEMPLATES, workload
from repro.core.sa import fit_normalizer
from repro.pathfinding import DesignSpace, Pathfinder, ScalarizationSweep
from repro.pathfinding.device import get_device_evaluator
from repro.pathfinding.pareto import directions_to_weights, simplex_directions
for k in range(1, 21):
    out[f"simplex{k}"] = simplex_directions(k)
    out[f"w6_{k}"] = directions_to_weights(simplex_directions(k))
out["w6_row"] = directions_to_weights(np.array([0.2, 0.3, 0.5]))
space = DesignSpace()
wl = workload(1)
norm = fit_normalizer(wl, samples=120, seed=7)
for dev in (True, False):
    pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space, device=dev)
    res = pf.search(ScalarizationSweep(**SWEEP), key=4)
    tag = f"ss{dev}/"
    out[tag + "history"] = np.array(res.history)
    out[tag + "best_cost"] = np.array(res.best_cost)
    out[tag + "best_enc"] = space.encode(res.best)
    out[tag + "evaluations"] = np.array(res.evaluations)
    out[tag + "front_enc"] = res.frontier.encoded
    out[tag + "front_vec"] = res.frontier.vectors
    for name, kw in (("budget", dict(budget=5)),
                     ("frontier0", dict(frontier_size=0))):
        budget = kw.pop("budget", None)
        try:
            pf.search(ScalarizationSweep(**SWEEP, **kw), budget=budget)
            out[f"refuse/{name}{dev}"] = np.array("none")
        except Exception as e:
            out[f"refuse/{name}{dev}"] = np.array(
                f"{type(e).__name__}: {e}")
pfb = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space)
res = pfb.search(ScalarizationSweep(**SWEEP), budget=20, key=4)
out["ssbudget/evaluations"] = np.array(res.evaluations)
out["ssbudget/history"] = np.array(res.history)
dev = get_device_evaluator(wl, space=space)
r = dev.parallel_tempering(inp["v0"], inp["temps"], NSW, SWAP, seed=13,
                           norm=norm, template=TEMPLATES["T2"],
                           weights=inp["w"], pair_mask=inp["mask"],
                           record_trace=True)
out["pt/final_enc"], out["pt/final_costs"] = r.final_enc, r.final_costs
out["pt/samples_enc"], out["pt/samples_vec"] = (r.samples["enc"],
                                                r.samples["vec"])
out["pt/history"] = np.array(r.history)
out["pt/best_enc"], out["pt/best_cost"] = r.best_enc, np.array(r.best_cost)
for k, a in r.trace.items():
    out["trace/" + k] = a
r0 = dev.parallel_tempering(inp["v0"], inp["temps"], 0, SWAP, seed=13,
                            norm=norm, template=TEMPLATES["T2"],
                            record_trace=True)
for k, a in r0.trace.items():
    out["trace0/" + k] = a
for name, kw in (("weights", dict(weights=inp["w"][:3])),
                 ("mask", dict(pair_mask=inp["mask"][:3]))):
    try:
        dev.parallel_tempering(inp["v0"], inp["temps"], 1, SWAP, seed=1,
                               norm=norm, template=TEMPLATES["T2"], **kw)
        out["shape/" + name] = np.array("none")
    except Exception as e:
        out["shape/" + name] = np.array(f"{type(e).__name__}: {e}")
"""


@pytest.fixture(scope="module")
def pt_inputs():
    rng = np.random.default_rng(5)
    v0 = DesignSpace().sample(N, key=17)
    ladder = 5.0 * (0.05 ** (np.arange(3) / 2))
    temps = np.concatenate([ladder, ladder, ladder[:2]])
    w = np.round(rng.random((N, 6)) * 4) / 4
    return v0, temps, w


@pytest.fixture(scope="module")
def ref(tmp_path_factory, pt_inputs):
    v0, temps, w = pt_inputs
    consts = f"SWEEP = {SWEEP!r}\nNSW = {SWEEPS}\nSWAP = {SWAP}\n"
    return run_reference(consts + REF,
                         {"v0": v0, "temps": temps, "w": w, "mask": MASK},
                         tmp_path_factory.mktemp("ref_scalarization"),
                         timeout=400)


@pytest.fixture(scope="module")
def norm():
    return fit_normalizer(workload(1), samples=120, seed=7)


@pytest.fixture(scope="module")
def dev():
    return get_device_evaluator(workload(1), space=DesignSpace(),
                                torch_device="cpu")


@pytest.fixture(scope="module")
def traced(dev, norm, pt_inputs):
    v0, temps, w = pt_inputs
    return dev.parallel_tempering(v0, temps, SWEEPS, SWAP, seed=13,
                                  norm=norm, template=TEMPLATES["T2"],
                                  weights=w, pair_mask=MASK,
                                  record_trace=True)


def _pf(norm, **kw):
    return Pathfinder(workload(1), TEMPLATES["T1"], norm=norm,
                      space=DesignSpace(), torch_device="cpu", **kw)


@pytest.mark.parametrize("k", range(1, 21))
def test_simplex_directions_match_reference(ref, k):
    d = simplex_directions(k)
    assert d.shape == (k, 3)
    np.testing.assert_array_equal(d, ref[f"simplex{k}"])
    np.testing.assert_array_equal(directions_to_weights(d), ref[f"w6_{k}"])


def test_directions_to_weights_row(ref):
    np.testing.assert_array_equal(
        directions_to_weights(np.array([0.2, 0.3, 0.5])), ref["w6_row"])
    with pytest.raises(ValueError, match="k >= 1"):
        simplex_directions(0)


@pytest.mark.parametrize("device", [True, False])
def test_sweep_matches_reference(ref, norm, device):
    pf = _pf(norm, device=device)
    res = pf.search(ScalarizationSweep(**SWEEP), key=4)
    tag = f"ss{device}/"
    assert res.evaluations == int(ref[tag + "evaluations"]) == 6 * 5
    np.testing.assert_array_equal(res.frontier.encoded, ref[tag + "front_enc"])
    np.testing.assert_allclose(res.frontier.vectors, ref[tag + "front_vec"],
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(pf.space.encode(res.best),
                                  ref[tag + "best_enc"])
    assert len(res.history) == len(ref[tag + "history"])
    np.testing.assert_allclose(res.history, ref[tag + "history"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(res.best_cost, ref[tag + "best_cost"],
                               rtol=RTOL)


def test_sweep_budget_truncates_like_reference(ref, norm):
    res = _pf(norm).search(ScalarizationSweep(**SWEEP), budget=20, key=4)
    assert res.evaluations == int(ref["ssbudget/evaluations"]) == 18
    np.testing.assert_allclose(res.history, ref["ssbudget/history"],
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("name", ["budget", "frontier0"])
def test_sweep_refusals_match_reference(ref, norm, device, name):
    kw = dict(frontier_size=0) if name == "frontier0" else {}
    budget = 5 if name == "budget" else None
    with pytest.raises(ValueError) as e:
        _pf(norm, device=device).search(ScalarizationSweep(**SWEEP, **kw),
                                        budget=budget)
    assert f"ValueError: {e.value}" == str(ref[f"refuse/{name}{device}"])


def test_pareto_front_defaults_to_sweep(norm):
    """``pareto_front()`` runs ``ScalarizationSweep()`` (16 directions x
    4 chains; the budget cuts it to one sweep) and returns its archive."""
    pf = _pf(norm)
    front = pf.pareto_front(budget=128, key=4)
    res = pf.search(ScalarizationSweep(), budget=128, key=4)
    assert res.evaluations == 128
    assert isinstance(front, ParetoArchive) and len(front) > 0
    np.testing.assert_array_equal(front.encoded, res.frontier.encoded)
    np.testing.assert_array_equal(front.vectors, res.frontier.vectors)
    assert ScalarizationSweep().weight_rows().shape == (16, 6)
    assert ScalarizationSweep().chain_pair_mask(64).sum() == 16 * 3


def test_weights_and_pair_mask_match_reference(ref, traced):
    r = traced
    np.testing.assert_array_equal(r.samples["enc"], ref["pt/samples_enc"])
    np.testing.assert_array_equal(r.final_enc, ref["pt/final_enc"])
    np.testing.assert_array_equal(r.best_enc, ref["pt/best_enc"])
    np.testing.assert_allclose(r.samples["vec"], ref["pt/samples_vec"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(r.final_costs, ref["pt/final_costs"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(r.history, ref["pt/history"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(r.best_cost, ref["pt/best_cost"], rtol=RTOL)


@pytest.mark.parametrize("field", TRACE_FIELDS)
def test_trace_matches_reference(ref, traced, field):
    got, want = traced.trace[field], ref["trace/" + field]
    assert got.shape == want.shape
    if field in ("proposals", "accepted", "u_accept", "u_swap"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TRACE_RTOL, atol=0)


def test_empty_trace_matches_reference(ref, dev, norm, pt_inputs):
    v0, temps, _ = pt_inputs
    r = dev.parallel_tempering(v0, temps, 0, SWAP, seed=13, norm=norm,
                               template=TEMPLATES["T2"], record_trace=True)
    for f in TRACE_FIELDS:
        want = ref["trace0/" + f]
        assert r.trace[f].shape == want.shape, f
        np.testing.assert_allclose(r.trace[f], want, rtol=TRACE_RTOL)


def test_trace_replays_on_host(traced, pt_inputs, norm):
    """Replaying the engine's recorded proposals and uniforms through a
    host loop on the scalar ``evaluate``, with each chain's own weight
    row and the pair mask, reproduces the accepted costs per sweep."""
    v0, temps, w = pt_inputs
    tr, sp, wl = traced.trace, DesignSpace(), workload(1)
    cache = SimCache()
    tpls = [Template(f"c{i}", *w[i]) for i in range(N)]

    def scost(row, i):
        return sa_cost(evaluate(sp.decode(row), wl, cache=cache), tpls[i],
                       norm)

    costs = [scost(v0[i], i) for i in range(N)]
    np.testing.assert_allclose(costs, tr["initial_costs"], rtol=TRACE_RTOL)
    hist, best_c = [min(costs)], min(costs)
    inv_t = 1.0 / temps
    for s in range(SWEEPS):
        pcost = [scost(tr["proposals"][s][i], i) for i in range(N)]
        u, us = tr["u_accept"][s], tr["u_swap"][s]
        for i in range(N):
            delta = pcost[i] - costs[i]
            ok = delta <= 0 or u[i] < math.exp(-delta / max(temps[i], 1e-12))
            assert ok == tr["accepted"][s][i]
            if ok:
                costs[i] = pcost[i]
                best_c = min(best_c, pcost[i])
        if s % SWAP == 0:
            for i in range(N - 1):
                d = (inv_t[i] - inv_t[i + 1]) * (costs[i] - costs[i + 1])
                if MASK[i] and (d >= 0 or us[i] < math.exp(min(d, 0.0))):
                    costs[i], costs[i + 1] = costs[i + 1], costs[i]
        hist.append(costs[-1])
        np.testing.assert_allclose(costs, tr["costs"][s], rtol=TRACE_RTOL,
                                   err_msg=f"sweep {s}")
    np.testing.assert_allclose(hist, traced.history, rtol=TRACE_RTOL)
    assert traced.best_cost == pytest.approx(best_c, rel=TRACE_RTOL)


def test_default_weights_bit_identical(dev, norm, pt_inputs):
    """``weights=None`` (the template's row for every chain) and an
    all-true mask run the engine as it ran before both existed."""
    v0, temps, _ = pt_inputs
    tpl = TEMPLATES["T2"]
    a = dev.parallel_tempering(v0, temps, SWEEPS, SWAP, seed=13, norm=norm,
                               template=tpl)
    b = dev.parallel_tempering(v0, temps, SWEEPS, SWAP, seed=13, norm=norm,
                               template=tpl,
                               weights=np.tile(tpl.weights, (N, 1)),
                               pair_mask=np.ones(N - 1, dtype=bool))
    assert a.history == b.history and a.trace is None
    np.testing.assert_array_equal(a.final_costs, b.final_costs)
    np.testing.assert_array_equal(a.samples["vec"], b.samples["vec"])
    np.testing.assert_array_equal(a.samples["enc"], b.samples["enc"])


def test_mask_blocks_swaps(dev, norm, pt_inputs):
    """An all-false mask never exchanges: each chain's cost history is
    then its own accept sequence."""
    v0, temps, w = pt_inputs
    r = dev.parallel_tempering(v0, temps, SWEEPS, 1, seed=13, norm=norm,
                               template=TEMPLATES["T2"], weights=w,
                               pair_mask=np.zeros(N - 1, dtype=bool),
                               record_trace=True)
    tr = r.trace
    prev = tr["initial_costs"]
    for s in range(SWEEPS):
        want = np.where(tr["accepted"][s], tr["proposal_costs"][s], prev)
        np.testing.assert_array_equal(tr["costs"][s], want)
        prev = want


@pytest.mark.parametrize("name", ["weights", "mask"])
def test_shape_errors_match_reference(ref, dev, norm, pt_inputs, name):
    v0, temps, w = pt_inputs
    kw = (dict(weights=w[:3]) if name == "weights"
          else dict(pair_mask=MASK[:3]))
    with pytest.raises(ValueError) as e:
        dev.parallel_tempering(v0, temps, 1, SWAP, seed=1, norm=norm,
                               template=TEMPLATES["T2"], **kw)
    assert f"ValueError: {e.value}" == str(ref["shape/" + name])


def test_trace_with_checkpoint_refused(dev, norm, pt_inputs):
    v0, temps, _ = pt_inputs
    with pytest.raises(ValueError, match="record_trace"):
        dev.parallel_tempering(v0, temps, 1, SWAP, seed=1, norm=norm,
                               template=TEMPLATES["T2"], record_trace=True,
                               checkpoint=object())


def test_carried_normalizer_runs_the_same_sweep(ref, norm):
    """The normalizer crosses packages as arrays: a sweep under the
    carried-over one equals the sweep under the port's own fit."""
    mins, meds = norm.weights_arrays()
    pf = _pf(normalizer_from_arrays(mins, meds))
    res = pf.search(ScalarizationSweep(**SWEEP), key=4)
    np.testing.assert_array_equal(res.frontier.encoded,
                                  ref["ssTrue/front_enc"])
