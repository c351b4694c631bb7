"""The single-table prefix gather: the port's plain torch version and its
wrapper ``prefix_segment_gather`` against the reference's Pallas kernel
in interpret mode (``prefix_segment_gather``) and its jnp oracle
(``prefix_segment_ref``), for float64, float32, int64 and int32 tables,
at ``tests/test_kernels.py``'s shapes, on the real workload-1 prefix
plane that ``chip_smoke.segment_inputs`` builds, and with empty
(``start == end``) slots; the wrapper's refusals; and the CUDA kernel
against the plain version on the card.

Every comparison is bitwise (``torch.equal``). Integer tables are exact.
The float64 tables hold integers below 2^53 and the float32 ones
integers below 2^24, so every difference and every total is exact too,
whatever order a sum takes (the reference's jnp oracle sums in an order
of its own; the kernel and the plain version both sum in slot order).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_support import REPO, run_reference

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


def _case(name, spec, dt):
    if name.startswith("wl1"):
        return _workload1(spec, dt)
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
    inputs = {"names": np.array([c[0] for c in CASES])}
    for name, spec, dt in CASES:
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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + [(1, 1, 1, 1), (64, 1025, 4096, 6)])
def test_cuda_kernel_equals_plain_on_card(shape, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t = _tensors(_synthetic(shape, dt, seed=1), device="cuda")
    before = segment_launch_count()
    diff, total = prefix_segment_gather(*t)
    torch.cuda.synchronize()
    assert segment_launch_count() == before + 1
    d_p, t_p = prefix_segment_plain(*t)
    assert torch.equal(diff, d_p) and torch.equal(total, t_p)
