"""The fused prefix-table gather: the port's plain torch version and its
wrapper against the reference's jnp oracle (``prefix_select_ref``) and
its Pallas kernel in interpret mode (``prefix_select_gather``), and the
CUDA kernel against the plain version on the card.

Tables are int64 and every output is a difference of two table entries,
so every comparison is exact (bitwise)."""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.kernels.prefix_gather import (
    launch_count,
    prefix_select,
    prefix_select_plain,
)

# (P systems, C slots, F metrics) by seed; any other seed is (48, 6, 5).
# P = 49 is no multiple of the CUDA kernel's 4 systems a block; the card
# cases add one system, a last partial block at P = 513, one slot a
# system, C * F above a block's 128 threads (40 x 5, 6 x 11: one system
# a block, its threads looping over the outputs), no slot (zero totals)
# and one output a system (64 systems a block).
SIZES = {4: (49, 6, 5), 5: (49, 6, 5), 6: (1, 6, 5), 7: (1, 6, 5),
         8: (513, 6, 5), 9: (513, 6, 5), 10: (49, 1, 5), 11: (513, 1, 5),
         12: (49, 40, 5), 13: (49, 6, 11), 14: (49, 0, 5), 15: (130, 1, 1)}


def _case(name, seed):
    """Synthetic int64 prefix tables and ranges. ``single``: one table
    pair with T0 != T1; ``stacked``: two workloads' tables edge-padded to
    a shared bucket and concatenated along rows, with per-row row offsets
    and per-row true tile totals. Ranges include out-of-range ends,
    empty segments and both split values."""
    P, C, F = SIZES.get(seed, (48, 6, 5))
    rng = np.random.default_rng(seed)

    def table(R, T, pad):
        inc = rng.integers(0, 1 << 40, (F, R, T), dtype=np.int64)
        pref = np.concatenate([np.zeros((F, R, 1), np.int64),
                               np.cumsum(inc, axis=-1)], axis=-1)
        return np.pad(pref, [(0, 0), (0, 0), (0, pad)], mode="edge")

    if name == "single":
        R, totals = 18, [(9, 14)]
        p0, p1 = table(R, 9, 0), table(R, 14, 0)
        wi = np.zeros(P, np.int64)
    else:
        R, totals = 18, [(9, 14), (5, 30)]
        p0 = np.concatenate([table(R, 9, 7), table(R, 5, 11)], axis=1)
        p1 = np.concatenate([table(R, 14, 18), table(R, 30, 2)], axis=1)
        wi = rng.integers(0, 2, P)
    t0 = np.array([totals[w][0] for w in wi], np.int32)
    t1 = np.array([totals[w][1] for w in wi], np.int32)
    rows = (rng.integers(0, R, (P, C)) + wi[:, None] * R).astype(np.int32)
    hi = np.maximum(t0, t1)[:, None] + 4
    start = rng.integers(-3, hi, (P, C)).astype(np.int32)
    end = rng.integers(-3, hi, (P, C)).astype(np.int32)
    end[::3, ::2] = start[::3, ::2]               # empty segments
    split = rng.integers(0, 2, P).astype(np.int32)
    return dict(p0=p0, p1=p1, rows=rows, start=start, end=end, split=split,
                t0=t0, t1=t1)


CASES = [("single", 0), ("single", 1), ("stacked", 2), ("stacked", 3),
         ("single", 4), ("stacked", 5)]
CARD_CASES = CASES + [("single", 6), ("stacked", 7), ("single", 8),
                      ("stacked", 9), ("single", 10), ("stacked", 11),
                      ("single", 12), ("stacked", 13), ("single", 14),
                      ("stacked", 15)]
ORDER = ("p0", "p1", "rows", "start", "end", "split", "t0", "t1")

REF = """
import jax.numpy as jnp
from repro.kernels.prefix_gather import prefix_select_gather, prefix_select_ref
with jax.enable_x64(True):
    for c in inp["names"]:
        a = [jnp.asarray(inp[f"{c}_{k}"]) for k in
             ("p0", "p1", "rows", "start", "end", "split", "t0", "t1")]
        out[f"{c}_ref_sel"], out[f"{c}_ref_tot"] = prefix_select_ref(*a)
        out[f"{c}_pl_sel"], out[f"{c}_pl_tot"] = prefix_select_gather(
            *a, interpret=True)
"""


def _tensors(case, device="cpu"):
    return [torch.as_tensor(case[k], device=device) for k in ORDER]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"names": np.array([f"{n}{s}" for n, s in CASES])}
    for n, s in CASES:
        for k, a in _case(n, s).items():
            inputs[f"{n}{s}_{k}"] = a
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_prefix"))


@pytest.mark.parametrize("impl", ["plain", "wrapper"])
@pytest.mark.parametrize("oracle", ["ref", "pl"])
@pytest.mark.parametrize("name,seed", CASES)
def test_prefix_select_bitwise(ref, name, seed, oracle, impl):
    fn = prefix_select_plain if impl == "plain" else prefix_select
    before = launch_count()
    sel, tot = fn(*_tensors(_case(name, seed)))
    assert launch_count() == before        # the CPU never launches
    assert sel.dtype == tot.dtype == torch.int64
    P, C, F = SIZES.get(seed, (48, 6, 5))
    assert sel.shape == (P, C, F) and tot.shape == (P, F)
    np.testing.assert_array_equal(sel.numpy(), ref[f"{name}{seed}_{oracle}_sel"])
    np.testing.assert_array_equal(tot.numpy(), ref[f"{name}{seed}_{oracle}_tot"])


def _bad(kind):
    a = _tensors(_case("single", 0))
    if kind == "float_table":
        a[0] = a[0].double()
    elif kind == "int64_rows":
        a[2] = a[2].long()
    elif kind == "bound_past_table":
        a[6] = torch.full_like(a[6], a[0].shape[2])
    elif kind == "negative_bound":
        a[7] = torch.full_like(a[7], -1)
    elif kind == "row_out_of_range":
        a[2][0, 0] = a[0].shape[1]
    elif kind == "shape":
        a[3] = a[3][:, :-1].contiguous()
    elif kind == "strided":
        a[4] = torch.as_strided(a[4].repeat(1, 2), a[4].shape,
                                (2 * a[4].shape[1], 1))
    return a


@pytest.mark.parametrize("kind,exc", [
    ("float_table", TypeError), ("int64_rows", TypeError),
    ("bound_past_table", ValueError), ("negative_bound", ValueError),
    ("row_out_of_range", ValueError), ("shape", ValueError),
    ("strided", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    with pytest.raises(exc):
        prefix_select(*_bad(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", CARD_CASES)
def test_cuda_kernel_matches_plain_on_card(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _tensors(_case(name, seed), device="cuda")
    before = launch_count()
    sel, tot = prefix_select(*args)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    sel_p, tot_p = prefix_select_plain(*args)
    assert torch.equal(sel, sel_p) and torch.equal(tot, tot_p)
