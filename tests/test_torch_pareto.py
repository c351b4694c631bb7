"""The port's Pareto machinery against the reference's: the exact
non-dominated filter (numpy) and its vectorized torch twin, crowding
distance, hypervolume and the bounded archive's insert sequence.

Exact equality throughout: every operation is a float64 comparison or
the same numpy arithmetic on the same inputs."""
import numpy as np
import pytest

from test_torch_support import run_reference

from repro_torch.convert import archive_from_arrays
from repro_torch.pathfinding.pareto import (
    ParetoArchive,
    crowding_distance,
    hypervolume,
    non_dominated_mask,
    non_dominated_mask_torch,
)

FRONTS = [(0, 40, 3), (1, 200, 3), (2, 64, 2), (3, 7, 1)]


def _front(seed, n, d):
    """Random points on a coarse grid, so ties and exact duplicates
    occur."""
    rng = np.random.default_rng(seed)
    return np.round(rng.random((n, d)) * 8) / 8


def _batches(seed):
    rng = np.random.default_rng(100 + seed)
    return [(rng.integers(0, 5, (k, 27)).astype(np.int32),
             np.round(rng.random((k, 3)) * 16) / 16)
            for k in (30, 700, 5, 90)]


REF = """
from repro.pathfinding.pareto import (
    ParetoArchive, crowding_distance, hypervolume, non_dominated_mask)
for s in inp["seeds"].tolist():
    p = inp[f"front{s}"]
    out[f"nd{s}"] = non_dominated_mask(p)
    out[f"cd{s}"] = crowding_distance(p)
    out[f"hv{s}"] = np.array(hypervolume(p, p.max(axis=0) + 0.25))
for s in (0, 1):
    arch = ParetoArchive(max_size=24)
    for b in range(4):
        arch.insert(inp[f"a{s}_enc{b}"], inp[f"a{s}_vec{b}"])
    for k, a in arch.checkpoint_arrays().items():
        out[f"arch{s}_{k}"] = a
    out[f"arch{s}_hv"] = np.array(arch.hypervolume())
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"seeds": np.array([s for s, _, _ in FRONTS])}
    for s, n, d in FRONTS:
        inputs[f"front{s}"] = _front(s, n, d)
    for s in (0, 1):
        for b, (enc, vec) in enumerate(_batches(s)):
            inputs[f"a{s}_enc{b}"], inputs[f"a{s}_vec{b}"] = enc, vec
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_pareto"))


@pytest.mark.parametrize("seed,n,d", FRONTS)
def test_filters_crowding_and_hypervolume_equal(ref, seed, n, d):
    p = _front(seed, n, d)
    np.testing.assert_array_equal(non_dominated_mask(p), ref[f"nd{seed}"])
    np.testing.assert_array_equal(
        non_dominated_mask_torch(p, torch_device="cpu"), ref[f"nd{seed}"])
    np.testing.assert_array_equal(crowding_distance(p), ref[f"cd{seed}"])
    assert hypervolume(p, p.max(axis=0) + 0.25) == float(ref[f"hv{seed}"])


def test_torch_filter_takes_batch_dimensions():
    p = np.stack([_front(s, 40, 3) for s in range(3)])
    got = non_dominated_mask_torch(p, torch_device="cpu")
    assert got.shape == (3, 40)
    for i in range(3):
        np.testing.assert_array_equal(got[i], non_dominated_mask(p[i]))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 1])
def test_archive_insert_sequence_equal(ref, seed, backend):
    arch = ParetoArchive(max_size=24, backend=backend, torch_device="cpu")
    for enc, vec in _batches(seed):
        arch.insert(enc, vec)
    np.testing.assert_array_equal(arch.encoded, ref[f"arch{seed}_enc"])
    np.testing.assert_array_equal(arch.vectors, ref[f"arch{seed}_vec"])
    assert arch.hypervolume() == float(ref[f"arch{seed}_hv"])
    carried = archive_from_arrays({"enc": ref[f"arch{seed}_enc"],
                                   "vec": ref[f"arch{seed}_vec"]},
                                  max_size=24)
    before = carried.encoded
    carried.merge(arch)                      # self-insert is a no-op
    np.testing.assert_array_equal(carried.encoded, before)
