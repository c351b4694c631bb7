"""The port's synthetic-token pipeline and ``randint`` against the
reference's, bit for bit.

The reference runs in a subprocess (see test_torch_support) with
``jax_threefry_partitionable=False``, the mode ``repro_torch.random``
reproduces. Tolerance: exact equality of every drawn integer and every
token.

- ``random.randint`` against ``jax.random.randint(..., jnp.int32)`` for
  spans of 504 (hubert-xlarge's classes), 49152 (smollm-135m's
  vocabulary) and 92553 (internvl2-26b's), and spans below and above
  2**16 where jax's multiplier wraps, at odd and even sizes.
- ``SyntheticTokenPipeline.batch`` for several (seed, step) and
  vocabularies, ``shard`` of it, and ``make_batch_specs`` for the dense,
  vlm and audio families.
"""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch import random as trandom
from repro_torch.configs import ShapeCell, get_config
from repro_torch.data import DataConfig, SyntheticTokenPipeline, \
    make_batch_specs

RANDINT = [  # (seed, fold, shape, minval, maxval)
    (0, 0, (7,), 0, 504), (3, 11, (4, 129), 0, 504),
    (1, 2, (5, 33), 0, 49152), (77, 7, (3, 257), 0, 92553),
    (9, 1, (1,), 0, 2), (4, 4, (2, 3, 5), -40, 60000),
    (5, 9, (6, 6), 100, 65636), (6, 0, (11,), 0, 70000)]
PIPES = [  # (vocab, seq_len, global_batch, seed, step)
    (49152, 16, 4, 0, 0), (49152, 16, 4, 0, 7), (504, 33, 3, 5, 2),
    (92553, 20, 2, 1, 123), (128, 12, 4, 0, 3), (64, 9, 2, 42, 1)]
SPEC_ARCHS = ["smollm-135m", "internvl2-26b", "hubert-xlarge"]
SPEC_CELL = (64, 4)      # (seq_len, global_batch)

REF = """
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.shapes import ShapeCell
from repro.data import DataConfig, SyntheticTokenPipeline, make_batch_specs

for i, (seed, fold, shape, lo, hi) in enumerate(RANDINT):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    out[f"randint/{i}"] = jax.random.randint(key, shape, lo, hi, jnp.int32)
for i, (vocab, seq, batch, seed, step) in enumerate(PIPES):
    pipe = SyntheticTokenPipeline(DataConfig(vocab, seq, batch, seed=seed))
    b = pipe.batch(step)
    out[f"pipe/{i}/tokens"], out[f"pipe/{i}/labels"] = b["tokens"], b["labels"]
    s = pipe.shard(step, 1, 2)
    out[f"shard/{i}/tokens"] = s["tokens"]
for name in SPEC_ARCHS:
    specs = make_batch_specs(get_config(name), ShapeCell("t", "train",
                                                         *SPEC_CELL))
    out[f"specs/{name}"] = np.array(
        [[k, str(v.shape), str(v.dtype)] for k, v in sorted(specs.items())])
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    consts = (f"RANDINT = {RANDINT!r}\nPIPES = {PIPES!r}\n"
              f"SPEC_ARCHS = {SPEC_ARCHS!r}\nSPEC_CELL = {SPEC_CELL!r}\n")
    return run_reference(consts + REF, None,
                         tmp_path_factory.mktemp("ref_data"))


@pytest.mark.parametrize("i", range(len(RANDINT)))
def test_randint_bit_equal(ref, i):
    seed, fold, shape, lo, hi = RANDINT[i]
    key = trandom.fold_in(trandom.PRNGKey(seed), fold)
    got = trandom.randint(key, shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), ref[f"randint/{i}"])
    assert int(got.min()) >= lo and int(got.max()) < hi


def test_randint_refuses_an_empty_range():
    with pytest.raises(ValueError, match="minval < maxval"):
        trandom.randint(trandom.PRNGKey(0), (3,), 5, 5)


@pytest.mark.parametrize("i", range(len(PIPES)))
def test_pipeline_tokens_bit_equal(ref, i):
    vocab, seq, batch, seed, step = PIPES[i]
    pipe = SyntheticTokenPipeline(DataConfig(vocab, seq, batch, seed=seed),
                                  torch_device="cpu")
    b = pipe.batch(step)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32 and b[k].shape == (batch, seq)
        assert np.array_equal(b[k].numpy(), ref[f"pipe/{i}/{k}"]), k
    # labels are the tokens shifted by one
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert np.array_equal(pipe.shard(step, 1, 2)["tokens"].numpy(),
                          ref[f"shard/{i}/tokens"])


def test_pipeline_is_step_indexed():
    """batch(step) depends on (seed, step) only: the same step twice is
    the same batch, another step or seed another."""
    pipe = SyntheticTokenPipeline(DataConfig(128, 16, 4), torch_device="cpu")
    a, b = pipe.batch(5)["tokens"], pipe.batch(5)["tokens"]
    assert torch.equal(a, b)
    assert not torch.equal(a, pipe.batch(6)["tokens"])
    other = SyntheticTokenPipeline(DataConfig(128, 16, 4, seed=1),
                                   torch_device="cpu")
    assert not torch.equal(a, other.batch(5)["tokens"])


def test_shards_cover_the_batch():
    pipe = SyntheticTokenPipeline(DataConfig(128, 8, 6), torch_device="cpu")
    parts = [pipe.shard(2, h, 3)["labels"] for h in range(3)]
    assert torch.equal(torch.cat(parts), pipe.batch(2)["labels"])


def test_pipeline_needs_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokenPipeline(DataConfig(128, 8, 2))


@pytest.mark.parametrize("name", SPEC_ARCHS)
def test_batch_specs_match_reference(ref, name):
    specs = make_batch_specs(get_config(name),
                             ShapeCell("t", "train", *SPEC_CELL))
    got = [[k, str(shape), str(dt).removeprefix("torch.")]
           for k, (shape, dt) in sorted(specs.items())]
    assert got == ref[f"specs/{name}"].tolist()
