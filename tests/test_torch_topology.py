"""The fused evaluator's topology stage (``repro_torch.kernels.topology``):
the wrapper runs the plain torch version on the CPU and launches nothing
there, refuses malformed input, and on the card the CUDA kernel equals
the plain version run on the same CUDA tensors, bit for bit, in every
output.

The layouts are ``test_torch_device.py``'s comm x schedule spaces, plus
a technology database whose protocols differ in hop latency (so the
evaluator's ``hop_uniform`` is None and ``hops3`` is live). The card
tests add spaces of 1 to 8 slots and 12 (the kernel with C at run time),
populations of 0, 1, 16 and 512 rows, and "wild" rows: every column the
stage reads drawn past the space's rules (chiplet counts beyond the
slots, unknown styles, any stack mask, indices outside the tables) with
die areas from a few values, so that sorts and maxima tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import workload
from repro_torch.core.techdb import DEFAULT_DB
from repro_torch.kernels.topology import (
    launch_count,
    topology,
    topology_plain,
)
from repro_torch.pathfinding import device as dev_mod
from repro_torch.pathfinding.device import DeviceEvaluator, _slots
from repro_torch.pathfinding.space import (
    COL_MEM,
    COL_N,
    COL_PAIR25,
    COL_PAIR3,
    COL_STACK,
    COL_STYLE,
    DesignSpace,
)

# every protocol at its own hop latency: the per-link-kind hop split
HETERO_DB = dataclasses.replace(DEFAULT_DB, protocols={
    k: dataclasses.replace(p, hop_latency_s=p.hop_latency_s * (1 + 0.5 * i))
    for i, (k, p) in enumerate(sorted(DEFAULT_DB.protocols.items()))})
# (comm, schedule, techdb)
LAYOUTS = {"legacy-fixed": ("legacy", "fixed", DEFAULT_DB),
           "mesh_noc-fixed": ("mesh_noc", "fixed", DEFAULT_DB),
           "legacy-window": ("legacy", "window", DEFAULT_DB),
           "mesh_noc-window": ("mesh_noc", "window", DEFAULT_DB),
           "hetero-hops": ("legacy", "fixed", HETERO_DB)}
AREA_LEVELS = np.array([0.0, 1.5, 2.25, 4.0, 7.176680000000001,
                        24.345599999999997])


def _evaluator(layout="legacy-fixed", C=6, device="cpu"):
    comm, sched, db = LAYOUTS[layout]
    space = DesignSpace(db, C, comm=comm, schedule=sched)
    return DeviceEvaluator(workload(1), db, space=space, torch_device=device)


def _sampled(ev, P, seed):
    """``(v, areas)`` of ``P`` designs drawn from the evaluator's space."""
    v = ev._enc(ev.space.sample(P, key=seed))
    return v, _slots(v, ev.tables, ev.cfg)["areas"]


def _wild(ev, P, seed):
    """``(v, areas)`` of ``P`` rows past the space's rules."""
    rng = np.random.default_rng(seed)
    cfg = ev.cfg
    v = ev.space.sample(P, key=seed).astype(np.int64)
    v[:, COL_N] = rng.integers(-1, cfg.C + 3, P)
    v[:, COL_STYLE] = rng.integers(-1, 5, P)
    v[:, COL_MEM] = rng.integers(-2, cfg.M + 2, P)
    v[:, COL_PAIR25] = rng.integers(-3, cfg.n_pairs25 + 3, P)
    v[:, COL_PAIR3] = rng.integers(-3, cfg.n_pairs3 + 3, P)
    v[:, COL_STACK] = rng.integers(-(1 << 31), 1 << 31, P)
    areas = AREA_LEVELS[rng.integers(0, len(AREA_LEVELS), (P, cfg.C))]
    return (torch.as_tensor(v, device=ev.device),
            torch.as_tensor(areas, device=ev.device))


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, a in got.items():
        b = want[k]
        assert (a.dtype, a.shape, a.stride()) == (b.dtype, b.shape,
                                                  b.stride()), k
        assert torch.equal(a, b), k


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_takes_plain_path_bit_for_bit(layout):
    ev = _evaluator(layout)
    v, areas = _sampled(ev, 512, seed=3)
    before = launch_count()
    got = dev_mod._topology(v, areas, ev.tables, ev.cfg)
    assert launch_count() == before
    _assert_same(got, topology_plain(v, areas, ev.tables, ev.cfg))
    assert bool((got["hops3"] > 0).any()) == (ev.cfg.hop_uniform is None)


def test_cpu_empty_population():
    ev = _evaluator()
    v, areas = _sampled(ev, 0, seed=1)
    out = topology(v, areas, ev.tables, ev.cfg)
    assert out["inc"].shape == (0, ev.cfg.L, ev.cfg.C)
    assert out["link_bw"].shape == (0, ev.cfg.L)


def _bad(kind):
    ev = _evaluator()
    v, areas = _sampled(ev, 8, seed=2)
    tb = dict(ev.tables)
    if kind == "v_dtype":
        v = v.to(torch.int32)
    elif kind == "areas_dtype":
        areas = areas.to(torch.float32)
    elif kind == "interp_dtype":
        tb["p25_interp"] = tb["p25_interp"].to(torch.uint8)
    elif kind == "v_width":
        v = v[:, :-1].contiguous()
    elif kind == "areas_shape":
        areas = areas[:, :-1].contiguous()
    elif kind == "table_shape":
        tb["p3"] = tb["p3"][:, :6].contiguous()
    elif kind == "contiguity":
        areas = areas.t().contiguous().t()
    elif kind == "device":
        tb["m_bw"] = tb["m_bw"].to("meta")
    elif kind == "unsupported_device":
        v, areas = v.to("meta"), areas.to("meta")
        tb = {k: tb[k].to("meta") for k in ("m_bw", "p25", "p25_interp",
                                             "p3")}
    return v, areas, tb, ev.cfg


@pytest.mark.parametrize("kind,exc", [
    ("v_dtype", TypeError), ("areas_dtype", TypeError),
    ("interp_dtype", TypeError), ("v_width", ValueError),
    ("areas_shape", ValueError), ("table_shape", ValueError),
    ("contiguity", ValueError), ("device", ValueError),
    ("unsupported_device", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    before = launch_count()
    with pytest.raises(exc):
        topology(*_bad(kind))
    assert launch_count() == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _card_check(ev, v, areas):
    before = launch_count()
    got = topology(v, areas, ev.tables, ev.cfg)
    torch.cuda.synchronize()
    assert launch_count() == before + (1 if v.shape[0] else 0)
    _assert_same(got, topology_plain(v, areas, ev.tables, ev.cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["sampled", "wild"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cuda_kernel_equals_plain_on_card(layout, rows):
    _need_card()
    ev = _evaluator(layout, device="cuda")
    draw = _sampled if rows == "sampled" else _wild
    _card_check(ev, *draw(ev, 4096, seed=11))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["sampled", "wild"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8, 12])
def test_cuda_every_slot_count_equals_plain_on_card(C, rows):
    """Every C with its own instance, and C = 12 on the kernel with C at
    run time."""
    _need_card()
    ev = _evaluator("mesh_noc-window", C=C, device="cuda")
    draw = _sampled if rows == "sampled" else _wild
    _card_check(ev, *draw(ev, 512, seed=C))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [0, 1, 16, 512])
def test_cuda_population_sizes_equal_plain_on_card(P):
    _need_card()
    ev = _evaluator("hetero-hops", device="cuda")
    _card_check(ev, *_sampled(ev, P, seed=P))

