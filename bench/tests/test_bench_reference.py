"""The frozen reference against the program on the CPU, at small
populations: the same normalizer, the same costs and objective vectors
(float64 round-off apart), the same seed populations, the same threefry
stream; and its float32 control reading past the limit that the
program's readings stay under."""
import random

import numpy as np
import pytest

from bench.harness.cell import load_cell, load_module
from bench.reference import Reference, threefry

_gap = load_module("judges", "tempering").gap

# a cell of each configuration
CELLS = ["pt-wl1-default", "pt-wl6-noc-window-default"]


def _program(config: dict):
    from repro_torch.core import workload
    from repro_torch.core.techdb import DEFAULT_DB
    from repro_torch.pathfinding import DesignSpace, Pathfinder

    space = DesignSpace(DEFAULT_DB, config["max_chiplets"],
                        comm=config["comm"], schedule=config["schedule"])
    pf = Pathfinder(workload(config["workloads"][0]), config["template"],
                    space=space, torch_device="cpu")
    pf.fit_normalizer(config["norm_samples"], config["norm_seed"])
    return pf, space


@pytest.fixture(scope="module", params=CELLS)
def pair(request):
    cell = load_cell(request.param)
    pf, space = _program(cell["config"])
    return cell, pf, space, Reference(cell["config"])


def test_normalizer_equal(pair):
    cell, pf, space, ref = pair
    mins, meds = pf.norm.weights_arrays()
    rmins, rmeds = ref.normalizer()
    np.testing.assert_array_equal(rmins, mins)
    np.testing.assert_array_equal(rmeds, meds)


def test_costs_and_vectors_equal(pair):
    cell, pf, space, ref = pair
    pop = space.sample(600, key=77)
    _, cost, vec = pf.evaluate_cost_vector(pop)
    x = ref.metrics(pop)
    assert _gap(cost, ref.costs(pop)) < 1e-14
    ref_vec = np.stack([x[:, 2], x[:, 3], x[:, 4] + x[:, 5]], axis=1)
    for j in range(3):
        assert _gap(vec[:, j], ref_vec[:, j]) < 1e-14


def test_seed_population_equal(pair):
    from repro_torch.core.sa import random_system, seed_noc, seed_schedule

    cell, pf, space, ref = pair
    rng = random.Random(2**40 + 3)
    chains = [random_system(rng, pf.db, space.max_chiplets)
              for _ in range(50)]
    if space.noc_live:
        chains = [seed_noc(s) for s in chains]
    if space.sched_live:
        chains = [seed_schedule(s) for s in chains]
    np.testing.assert_array_equal(ref.seed_population(2**40 + 3, 50),
                                  space.encode_many(chains))


def test_float32_control_fails_the_limit(pair):
    cell, pf, space, ref = pair
    pop = space.sample(300, key=5)
    limit = cell["limits"]["cost_gap"]
    _, cost, _ = pf.evaluate_cost_vector(pop)
    ref64 = ref.costs(pop)
    ref32 = Reference(cell["config"], float32=True).costs(pop)
    assert _gap(cost, ref64) < limit
    assert _gap(ref32, ref64) > limit


def test_algorithm1_ties_follow_the_sequential_fold():
    """Three designs of workload 1 whose Algorithm 1 leftover goes by an
    ulp-level tie of fractional parts: the reference's sequential fold of
    the core powers gives the batched evaluator's tile counts (the
    built-in ``sum()`` of Python 3.12 would not)."""
    config = load_cell("pt-wl1-default")["config"]
    pf, space = _program(config)
    pop = space.sample(4000, key=5)[[68, 2579, 2720]]
    mb = pf.evaluate_batch(pop)
    ref = Reference(config)
    np.testing.assert_allclose(ref.metrics(pop)[:, 2], mb.latency_s,
                               rtol=1e-14)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2147483700 * 1000 + 3,
                                  2**64 - 1])
def test_threefry_stream_equal(seed):
    from repro_torch import random as trandom

    k, kn = trandom.PRNGKey(seed), threefry.prng_key(seed)
    np.testing.assert_array_equal(k.numpy().astype(np.uint32), kn)
    for _ in range(3):
        ks, ksn = trandom.split(k, 4), threefry.split(kn, 4)
        np.testing.assert_array_equal(ks.numpy().astype(np.uint32), ksn)
        k, _, ka, _ = ks
        kn, _, kan, _ = ksn
        for n in (1, 511, 512):
            np.testing.assert_array_equal(trandom.uniform(ka, (n,)).numpy(),
                                          threefry.uniform(kan, n))
