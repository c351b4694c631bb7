"""The port's DesignSpace against the reference's: sampled populations,
bounds, move tables, validity masks and encode/decode, bit for bit, for
every comm x schedule layout."""
import numpy as np
import pytest

from test_torch_support import run_reference

from repro_torch.pathfinding.space import DesignSpace

LAYOUTS = [("legacy", "fixed"), ("mesh_noc", "fixed"), ("legacy", "window"),
           ("mesh_noc", "window")]
SEEDS = [0, 7, 1234]
N = 200


def _perturbed(space, seed):
    """Sampled rows with random columns nudged by -2..2: a mix of valid
    and invalid rows for the validity mask."""
    rng = np.random.default_rng(seed)
    v = space.sample(N, key=seed).astype(np.int64)
    hit = rng.random(v.shape) < 0.05
    v[hit] += rng.integers(-2, 3, int(hit.sum()))
    return v.astype(np.int32)


REF = """
from repro.pathfinding.space import DesignSpace
LAYOUTS = [("legacy", "fixed"), ("mesh_noc", "fixed"), ("legacy", "window"),
           ("mesh_noc", "window")]
for li, (comm, sched) in enumerate(LAYOUTS):
    sp = DesignSpace(comm=comm, schedule=sched)
    lo, hi = sp.bounds()
    out[f"lo{li}"], out[f"hi{li}"] = lo, hi
    for k, a in sp.move_tables().items():
        out[f"mt{li}_{k}"] = a
    for s in (0, 7, 1234):
        out[f"sample{li}_{s}"] = sp.sample(200, key=s)
        pert = inp[f"pert{li}_{s}"]
        out[f"valid{li}_{s}"] = sp.validity_mask(pert)
        enc = out[f"sample{li}_{s}"]
        systems = sp.decode_many(enc)
        out[f"describe{li}_{s}"] = np.array([x.describe() for x in systems])
        out[f"reenc{li}_{s}"] = sp.encode_many(systems)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {}
    for li, (comm, sched) in enumerate(LAYOUTS):
        sp = DesignSpace(comm=comm, schedule=sched)
        for s in SEEDS:
            inputs[f"pert{li}_{s}"] = _perturbed(sp, s)
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_space"))


@pytest.fixture(scope="module")
def spaces():
    return [DesignSpace(comm=c, schedule=s) for c, s in LAYOUTS]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_sample_bit_equal(ref, spaces, li, seed):
    got = spaces[li].sample(N, key=seed)
    assert got.dtype == ref[f"sample{li}_{seed}"].dtype
    np.testing.assert_array_equal(got, ref[f"sample{li}_{seed}"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_validity_mask_bit_equal(ref, spaces, li, seed):
    pert = _perturbed(spaces[li], seed)
    got = spaces[li].validity_mask(pert)
    np.testing.assert_array_equal(got, ref[f"valid{li}_{seed}"])
    assert 0 < got.sum() < len(got)   # both kinds of rows present


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_decode_encode_bit_equal(ref, spaces, li, seed):
    sp = spaces[li]
    systems = sp.decode_many(ref[f"sample{li}_{seed}"])
    assert [x.describe() for x in systems] == \
        ref[f"describe{li}_{seed}"].tolist()
    np.testing.assert_array_equal(sp.encode_many(systems),
                                  ref[f"reenc{li}_{seed}"])


@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_bounds_and_move_tables_bit_equal(ref, spaces, li):
    lo, hi = spaces[li].bounds()
    np.testing.assert_array_equal(lo, ref[f"lo{li}"])
    np.testing.assert_array_equal(hi, ref[f"hi{li}"])
    mt = spaces[li].move_tables()
    keys = {k[len(f"mt{li}_"):] for k in ref if k.startswith(f"mt{li}_")}
    assert set(mt) == keys
    for k in keys:
        np.testing.assert_array_equal(mt[k], ref[f"mt{li}_{k}"])
