"""The port's batched evaluator against the reference's.

Host tables (the int64 ScaleSim prefix tables, the chiplet physicals)
are plain numpy in both packages and must be bit-equal. The 13 metric
arrays and the batched normalizer fit go through float64 torch in the
port and float64 jax.numpy in the reference: tolerance 1e-6 relative,
the repo's parity contract (reductions may sum in another order)."""
import numpy as np
import pytest

from test_torch_support import run_reference

from repro_torch.convert import normalizer_from_arrays
from repro_torch.core import workload
from repro_torch.pathfinding.batch import (
    _SIM_METRICS,
    MetricsBatch,
    evaluate_batch,
    fit_normalizer_batched,
    get_evaluator,
)
from repro_torch.pathfinding.space import DesignSpace

RTOL = 1e-6
WORKLOADS = [1, 6]
LAYOUTS = [("legacy", "fixed"), ("mesh_noc", "window")]
FIELDS = [f for f in MetricsBatch.__dataclass_fields__]
TABLES = ["t_area", "t_static", "t_cost", "t_mfg", "t_buf", "t_freq",
          "t_des", "t_sram_e", "t_mac_e", "t_power", "m_bw", "m_rd", "m_wr",
          "m_cost", "p25_hl", "p3_hl"]

REF = """
from repro.core import workload
from repro.pathfinding.batch import (
    _SIM_METRICS, evaluate_batch, fit_normalizer_batched, get_evaluator)
from repro.pathfinding.space import DesignSpace
for w in (1, 6):
    ev = get_evaluator(workload(w))
    for sk in (0, 1):
        for f in _SIM_METRICS:
            out[f"pref{w}_{sk}_{f}"] = ev.tiles[sk]["pref"][f]
        out[f"mn{w}_{sk}"] = ev.tiles[sk]["mn_pref"]
    for name in inp["tables"]:
        out[f"{name}{w}"] = getattr(ev, name)
    for li, (comm, sched) in enumerate([("legacy", "fixed"),
                                        ("mesh_noc", "window")]):
        sp = DesignSpace(comm=comm, schedule=sched)
        mb = evaluate_batch(inp[f"enc{li}"], workload(w), space=sp)
        for f, a in mb.__dict__.items():
            out[f"mb{w}_{li}_{f}"] = a
    norm = fit_normalizer_batched(workload(w), samples=400, seed=7)
    out[f"mins{w}"], out[f"med{w}"] = norm.weights_arrays()
"""


@pytest.fixture(scope="module")
def encs():
    return {li: DesignSpace(comm=c, schedule=s).sample(240, key=21 + li)
            for li, (c, s) in enumerate(LAYOUTS)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, encs):
    inputs = {f"enc{li}": e for li, e in encs.items()}
    inputs["tables"] = np.array(TABLES)
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_batch"))


@pytest.mark.parametrize("sk", [0, 1])
@pytest.mark.parametrize("w", WORKLOADS)
def test_prefix_tables_bit_equal(ref, w, sk):
    ev = get_evaluator(workload(w))
    for f in _SIM_METRICS:
        got = ev.tiles[sk]["pref"][f]
        assert got.dtype == np.int64 and got.ndim == 4   # [A, S, 3, T+1]
        np.testing.assert_array_equal(got, ref[f"pref{w}_{sk}_{f}"])
    np.testing.assert_array_equal(ev.tiles[sk]["mn_pref"],
                                  ref[f"mn{w}_{sk}"])


@pytest.mark.parametrize("w", WORKLOADS)
def test_chiplet_and_package_tables_bit_equal(ref, w):
    ev = get_evaluator(workload(w))
    for name in TABLES:
        np.testing.assert_array_equal(getattr(ev, name), ref[f"{name}{w}"],
                                      err_msg=name)


@pytest.mark.parametrize("li", range(len(LAYOUTS)))
@pytest.mark.parametrize("w", WORKLOADS)
def test_metrics_batch_within_tolerance(ref, encs, w, li):
    c, s = LAYOUTS[li]
    mb = evaluate_batch(encs[li], workload(w),
                        space=DesignSpace(comm=c, schedule=s),
                        torch_device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(mb, f), ref[f"mb{w}_{li}_{f}"],
                                   rtol=RTOL, atol=0, err_msg=f)


@pytest.mark.parametrize("w", WORKLOADS)
def test_fit_normalizer_batched_within_tolerance(ref, w):
    norm = fit_normalizer_batched(workload(w), samples=400, seed=7,
                                  torch_device="cpu")
    mins, med = norm.weights_arrays()
    np.testing.assert_allclose(mins, ref[f"mins{w}"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(med, ref[f"med{w}"], rtol=RTOL, atol=0)
    carried = normalizer_from_arrays(ref[f"mins{w}"], ref[f"med{w}"])
    np.testing.assert_array_equal(carried.weights_arrays()[0], ref[f"mins{w}"])
    np.testing.assert_array_equal(carried.weights_arrays()[1], ref[f"med{w}"])
