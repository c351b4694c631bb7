"""The single-table prefix gather: the port's plain torch version and its
wrapper ``prefix_segment_gather`` against the reference's Pallas kernel
in interpret mode (``prefix_segment_gather``) and its jnp oracle
(``prefix_segment_ref``), for float64, float32, int64 and int32 tables,
at ``tests/test_kernels.py``'s shapes, on the real workload-1 prefix
plane that ``chip_smoke.segment_inputs`` builds, and with empty
(``start == end``) slots; the wrapper's refusals; and the CUDA kernel
against the plain version on the card.

The comparisons of those cases are bitwise (``torch.equal``). Integer
tables are exact. Those float64 tables hold integers below 2^53 and the
float32 ones integers below 2^24, so every difference and every total is
exact too, whatever order a sum takes.

The fractional cases (float64 and float32 tables of non-integer values,
the running sums of uniform draws) are where the order of a sum shows.
The reference's Pallas kernel sums the slots in order from slot 0's
difference, as the plain version and the CUDA kernel do, so those are
held bitwise; its jnp oracle sums in an order of its own, so its totals
are held within C * eps * sum_c |diff[p, c]| (a bound on how far two
orders of a C-term sum can round apart) and its differences bitwise.

The card tests run every C from 1 to 9, 16 and 33 (the unrolled kernel
and the grouped one, whose slots at C = 33 span two groups of a warp),
P that is no multiple of a warp's systems or of a block, index tensors
that are views with only 4- or 8-byte-aligned bases, and fractional
tables, bitwise against the plain version, with the launch geometry the
case should take.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_support import REPO, run_reference

from repro_torch.kernels.prefix_gather import ops
from repro_torch.kernels.prefix_gather import (
    prefix_segment_gather,
    prefix_segment_plain,
    segment_launch_count,
)

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "int64": torch.int64, "int32": torch.int32}
SHAPES = [(48, 91, 64, 6), (5, 13, 17, 3)]                 # (R, T+1, P, C)
IMPLS = {"plain": prefix_segment_plain, "wrapper": prefix_segment_gather}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic(shape, dt, seed):
    """Prefix table with increments in [0, hi): hi = 10^9 for 64-bit
    tables, 1000 for 32-bit ones; in-range ranges, a third of them
    empty."""
    R, T1, P, C = shape
    rng = np.random.default_rng(seed)
    hi = 10 ** 9 if dt in ("float64", "int64") else 1000
    pref = np.cumsum(rng.integers(0, hi, (R, T1)), axis=1)
    rows = rng.integers(0, R, (P, C))
    start = rng.integers(0, T1, (P, C))
    end = np.minimum(start + rng.integers(0, T1, (P, C)), T1 - 1)
    end[::3] = start[::3]
    return dict(pref=pref.astype(dt), rows=rows.astype(np.int32),
                start=start.astype(np.int32), end=end.astype(np.int32))


def _workload1(P, dt):
    pref, rows, start, end = _chip_smoke().segment_inputs(
        P, seed=P, dev="cpu", dtype=DTYPES[dt])
    return dict(pref=pref.numpy(), rows=rows.numpy(), start=start.numpy(),
                end=end.numpy())


CASES = ([(f"{dt}-{'x'.join(map(str, s))}", s, dt) for s in SHAPES
          for dt in DTYPES]
         + [(f"wl1-{dt}-P{P}", P, dt) for P in (512, 4096)
            for dt in ("int64", "float64")])


def _fractional(shape, dt, seed):
    """A table of running sums of uniform draws in [0, 1), so no entry and
    no difference is an integer; in-range ranges, a third of them empty."""
    case = _synthetic(shape, "int64", seed)
    R, T1 = shape[:2]
    rng = np.random.default_rng(seed + 1)
    case["pref"] = np.cumsum(rng.random((R, T1)), axis=1).astype(dt)
    return case


FRAC_CASES = [(f"frac-{dt}-{'x'.join(map(str, s))}", s, dt)
              for s in SHAPES + [(64, 1025, 512, 6)]
              for dt in ("float64", "float32")]


def _case(name, spec, dt):
    if name.startswith("wl1"):
        return _workload1(spec, dt)
    if name.startswith("frac"):
        return _fractional(spec, dt, seed=sum(spec))
    return _synthetic(spec, dt, seed=sum(spec) + len(dt))


REF = """
import jax.numpy as jnp
from repro.kernels.prefix_gather import (prefix_segment_gather,
                                         prefix_segment_ref)
with jax.enable_x64(True):
    for c in inp["names"]:
        a = [jnp.asarray(inp[f"{c}_{k}"])
             for k in ("pref", "rows", "start", "end")]
        out[f"{c}_pl_diff"], out[f"{c}_pl_tot"] = prefix_segment_gather(
            *a, interpret=True)
        out[f"{c}_ref_diff"], out[f"{c}_ref_tot"] = prefix_segment_ref(*a)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"names": np.array([c[0] for c in CASES + FRAC_CASES])}
    for name, spec, dt in CASES + FRAC_CASES:
        for k, a in _case(name, spec, dt).items():
            inputs[f"{name}_{k}"] = a
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_segment"))


def _tensors(case, device="cpu"):
    return [torch.as_tensor(case[k], device=device)
            for k in ("pref", "rows", "start", "end")]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("oracle", ["pl", "ref"])
@pytest.mark.parametrize("name,spec,dt", CASES, ids=[c[0] for c in CASES])
def test_prefix_segment_bitwise(ref, name, spec, dt, oracle, impl):
    case = _case(name, spec, dt)
    before = segment_launch_count()
    diff, total = IMPLS[impl](*_tensors(case))
    assert segment_launch_count() == before    # the CPU never launches
    P, C = case["rows"].shape
    assert diff.dtype == total.dtype == DTYPES[dt]
    assert diff.shape == (P, C) and total.shape == (P,)
    assert str(ref[f"{name}_{oracle}_diff"].dtype) == dt
    assert torch.equal(diff, torch.from_numpy(ref[f"{name}_{oracle}_diff"]))
    assert torch.equal(total, torch.from_numpy(ref[f"{name}_{oracle}_tot"]))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("name,spec,dt", FRAC_CASES,
                         ids=[c[0] for c in FRAC_CASES])
def test_prefix_segment_fractional_sums_in_slot_order(ref, name, spec, dt,
                                                      impl):
    case = _case(name, spec, dt)
    diff, total = IMPLS[impl](*_tensors(case))
    pl_diff = torch.from_numpy(ref[f"{name}_pl_diff"])
    pl_tot = torch.from_numpy(ref[f"{name}_pl_tot"])
    assert diff.dtype == total.dtype == pl_diff.dtype == DTYPES[dt]
    assert (diff != diff.round()).any()          # not integers
    assert torch.equal(diff, pl_diff) and torch.equal(total, pl_tot)
    assert torch.equal(diff, torch.from_numpy(ref[f"{name}_ref_diff"]))
    ref_tot = torch.from_numpy(ref[f"{name}_ref_tot"])
    C = diff.shape[1]
    bound = C * torch.finfo(diff.dtype).eps * diff.abs().sum(dim=1)
    assert ((total - ref_tot).abs() <= bound).all()


def test_workload1_ranges_are_real():
    """The workload-1 case gathers real, non-empty ranges (about 40 % of
    the slots: designs with fewer chiplets than slots leave the rest
    empty), beside empty ones."""
    case = _workload1(512, "int64")
    diff, _ = prefix_segment_plain(*_tensors(case))
    assert (diff > 0).float().mean() > 0.25
    assert (case["start"] == case["end"]).any()


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_int64_indices_are_cast(impl):
    case = _synthetic((5, 13, 17, 3), "int64", seed=9)
    t = _tensors(case)
    want = prefix_segment_plain(*t)
    got = IMPLS[impl](t[0], *(x.long() for x in t[1:]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _bad(kind):
    pref, rows, start, end = _tensors(_synthetic((5, 13, 17, 3), "int64",
                                                 seed=3))
    if kind == "row_past_R":
        rows[0, 0] = pref.shape[0]
    elif kind == "negative_row":
        rows[1, 2] = -1
    elif kind == "start_negative":
        start[2, 1] = -1
    elif kind == "end_past_T":
        end[3, 0] = pref.shape[1]
    elif kind == "no_slots":
        rows, start, end = (x[:, :0] for x in (rows, start, end))
    elif kind == "devices":
        end = end.to("meta")
    elif kind == "float16_table":
        pref = pref.half()
    elif kind == "float_indices":
        start = start.float()
    elif kind == "table_rank":
        pref = pref[None]
    elif kind == "shape":
        end = end[:, :-1]
    return pref, rows, start, end


@pytest.mark.parametrize("kind,exc", [
    ("row_past_R", ValueError), ("negative_row", ValueError),
    ("start_negative", ValueError), ("end_past_T", ValueError),
    ("no_slots", ValueError), ("devices", ValueError),
    ("float16_table", TypeError), ("float_indices", TypeError),
    ("table_rank", ValueError), ("shape", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    with pytest.raises(exc):
        prefix_segment_gather(*_bad(kind))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + [(1, 1, 1, 1), (64, 1025, 4096, 6)])
def test_cuda_kernel_equals_plain_on_card(shape, dt):
    _need_card()
    t = _tensors(_synthetic(shape, dt, seed=1), device="cuda")
    before = segment_launch_count()
    diff, total = prefix_segment_gather(*t)
    torch.cuda.synchronize()
    assert segment_launch_count() == before + 1
    d_p, t_p = prefix_segment_plain(*t)
    assert torch.equal(diff, d_p) and torch.equal(total, t_p)


def _at_offset(x, elems):
    """``x`` as a contiguous view ``elems`` elements into a fresh buffer
    (a fresh buffer starts on at least 16 bytes)."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    view = buf[elems:].view(x.shape)
    view.copy_(x)
    return view


def _card_check(case, dt, offsets=(0, 0, 0)):
    pref, *idx = _tensors(case, device="cuda")
    rows, start, end = (_at_offset(x, o) for x, o in zip(idx, offsets))
    P, C = rows.shape
    kernel = "unrolled" if C <= 8 else "grouped"   # C at compile time
    geo = ops.segment_geometry(P, C)
    systems = 32 // min(C, 32)                  # a thread per slot
    assert geo["kernel"] == kernel and geo["systems"] == systems
    assert geo["blocks"] == -(-32 * -(-P // systems) // geo["threads"])
    before = dict(ops.prefix_segment_gather.path_launches)
    diff, total = prefix_segment_gather(pref, rows, start, end)
    torch.cuda.synchronize()
    after = ops.prefix_segment_gather.path_launches
    assert after[kernel] == before[kernel] + 1
    d_p, t_p = prefix_segment_plain(pref, rows, start, end)
    assert diff.dtype == DTYPES[dt]
    assert torch.equal(diff, d_p) and torch.equal(total, t_p)


CARD_CS = list(range(1, 10)) + [16, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("P", [1, 33, 300])
@pytest.mark.parametrize("C", CARD_CS)
def test_cuda_every_slot_count_equals_plain_on_card(C, P, dt):
    """Both kernels, every unrolled C, P off the block; float tables hold
    non-integer values."""
    _need_card()
    shape = (7, 19, P, C)
    case = (_fractional(shape, dt, seed=C * 1000 + P) if "float" in dt
            else _synthetic(shape, dt, seed=C * 1000 + P))
    _card_check(case, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float64", "int32"])
@pytest.mark.parametrize("offsets", [(1, 1, 1), (2, 2, 2), (0, 0, 1),
                                     (0, 2, 0), (3, 1, 2)])
@pytest.mark.parametrize("C", [2, 3, 4, 6, 8, 9])
def test_cuda_unaligned_index_views_equal_plain_on_card(C, offsets, dt):
    """Index tensors that start 4 or 8 bytes past a 16-byte boundary, as
    the wrapper's int32 casts may be."""
    _need_card()
    shape = (11, 33, 300, C)
    case = (_fractional(shape, dt, seed=C) if "float" in dt
            else _synthetic(shape, dt, seed=C))
    _card_check(case, dt, offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("name,spec,dt", FRAC_CASES,
                         ids=[c[0] for c in FRAC_CASES])
def test_cuda_fractional_tables_equal_plain_on_card(name, spec, dt):
    _need_card()
    _card_check(_case(name, spec, dt), dt)
