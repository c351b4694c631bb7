"""The port's threefry2x32 stream against jax's, bit for bit.

The reference runs in a subprocess (see test_torch_support) with
``jax_threefry_partitionable=False``, the mode the device-search goldens
were recorded in. Tolerance: exact equality of every key word and every
float64 draw."""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch import random as trandom

SEEDS = [0, 3, 7, 0x9E3779B9, 2 ** 40 + 17, -5]
SPLITS = [2, 4, 7]
FOLDS = [0, 7, 8, 123456789]
SHAPES = [(1,), (5, 3), (37, 512), (4,)]

REF = """
import jax.numpy as jnp
SEEDS = [0, 3, 7, 0x9E3779B9, 2 ** 40 + 17, -5]
with jax.enable_x64(True):
    for i, s in enumerate(SEEDS):
        k = jax.random.PRNGKey(s)
        out[f"key{i}"] = np.asarray(k)
        for n in (2, 4, 7):
            out[f"split{i}_{n}"] = np.asarray(jax.random.split(k, n))
        for d in (0, 7, 8, 123456789):
            out[f"fold{i}_{d}"] = np.asarray(jax.random.fold_in(k, d))
        for j, shp in enumerate([(1,), (5, 3), (37, 512), (4,)]):
            out[f"uni{i}_{j}"] = np.asarray(
                jax.random.uniform(k, shp, dtype=jnp.float64))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, None, tmp_path_factory.mktemp("ref_random"))


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_prng_key_bit_equal(ref, i):
    np.testing.assert_array_equal(trandom.PRNGKey(SEEDS[i]).numpy(),
                                  _words(ref[f"key{i}"]))


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_split_bit_equal(ref, i, n):
    got = trandom.split(trandom.PRNGKey(SEEDS[i]), n)
    np.testing.assert_array_equal(got.numpy(), _words(ref[f"split{i}_{n}"]))


@pytest.mark.parametrize("d", FOLDS)
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fold_in_bit_equal(ref, i, d):
    got = trandom.fold_in(trandom.PRNGKey(SEEDS[i]), d)
    np.testing.assert_array_equal(got.numpy(), _words(ref[f"fold{i}_{d}"]))


@pytest.mark.parametrize("j", range(len(SHAPES)))
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_uniform_bit_equal(ref, i, j):
    got = trandom.uniform(trandom.PRNGKey(SEEDS[i]), SHAPES[j])
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref[f"uni{i}_{j}"])

