"""Wrapper, build and launch count of the topology kernel.

:func:`topology` is the fused evaluator's whole topology stage (see
:mod:`~repro_torch.kernels.topology.ref`). On a CUDA tensor it launches
the hand-written Hopper kernel in ``csrc/topology.cu``, one thread a
design row (C at compile time for 1 <= C <= 8, at run time up to
:data:`MAX_C`), and runs :func:`~repro_torch.kernels.topology.ref.
bonding` in torch on what the kernel wrote; on a CPU tensor it runs the
plain version, :func:`~repro_torch.kernels.topology.ref.topology_plain`.
There is no other switch, and a failed build or launch raises. Inputs
are checked on the host, from their shapes, dtypes and devices alone:
the check reads nothing back from the device.

The kernel is built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, under ``build/kernels/``) at first use and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topology.ref import bonding, topology_plain
from repro_torch.pathfinding.space import (
    COL_MEM,
    COL_N,
    COL_PAIR25,
    COL_PAIR3,
    COL_STACK,
    COL_STYLE,
    S_25D,
    S_2D,
    S_3D,
    S_HYBRID,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "topology.cu"
# the encoding's stack column is an int32 with one bit a slot
MAX_C = 32
# the columns the kernel reads and the style codes, in the order of its
# ``Layout`` struct
LAYOUT = (COL_N, COL_STYLE, COL_MEM, COL_PAIR25, COL_PAIR3, COL_STACK, S_2D,
          S_25D, S_3D, S_HYBRID)

F64, I64, BOOL = torch.float64, torch.int64, torch.bool


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.topology_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def launch_count() -> int:
    """``topology`` launches since the last :func:`reset_launch_count`."""
    return topology.launches


def reset_launch_count() -> None:
    topology.launches = 0


def _check(v, areas, tb, cfg) -> None:
    tabs = (tb["m_bw"], tb["p25"], tb["p25_interp"], tb["p3"])
    ts = (v, areas) + tabs
    if any(x.device != v.device for x in ts):
        raise ValueError("topology: all tensors must share one device")
    if v.dtype != I64:
        raise TypeError(f"topology: v must be int64, got {v.dtype}")
    if any(x.dtype != F64 for x in (areas, tabs[0], tabs[1], tabs[3])) or \
            tabs[2].dtype != BOOL:
        raise TypeError("topology: areas and tables must be float64, "
                        "p25_interp bool")
    C = cfg.C
    P = v.shape[0]
    if v.dim() != 2 or v.shape[1] != cfg.W or areas.shape != (P, C):
        raise ValueError(f"topology: v must be [P, {cfg.W}] and areas "
                         f"[P, {C}]; got {tuple(v.shape)}, "
                         f"{tuple(areas.shape)}")
    if (tabs[0].shape != (cfg.M,) or tabs[1].shape != (cfg.n_pairs25, 7)
            or tabs[2].shape != (cfg.n_pairs25,)
            or tabs[3].shape != (cfg.n_pairs3, 7)):
        raise ValueError("topology: tables must be m_bw [M], p25 [n25, 7], "
                         "p25_interp [n25], p3 [n3, 7]")
    if cfg.L != C * (C - 1) // 2 + C - 1:
        raise ValueError(f"topology: {cfg.L} link slots for C = {C}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("topology: tensors must be contiguous")


def empty_outputs(P: int, C: int, L: int, device) -> Dict[str,
                                                           torch.Tensor]:
    """The kernel's outputs for P rows, empty, in the order of its ``Out``
    struct. ``inc_s`` is ``inc`` source-major (``[P, C, L]``); ``row_f``
    holds n_f, m_f, cl_f, y25, y3, cfp3 and ``row_b`` is25, is3d, ishyb,
    the inputs of the bonding tail."""
    def empty(dtype, *shape):
        return torch.empty((P, *shape), dtype=dtype, device=device)

    return dict(eff_bw=empty(F64, C), dram_e=empty(F64, C),
                hops=empty(I64, C), hops3=empty(I64, C),
                link_bw=empty(F64, L), link_e=empty(F64, L),
                inc_s=empty(F64, C, L), pkg_area=empty(F64),
                assembly=empty(F64), p25_rate=empty(F64), interp=empty(BOOL),
                is2d=empty(BOOL), dest=empty(I64), a_bond=empty(F64, C),
                row_f=empty(F64, 6), row_b=empty(BOOL, 3))


def launch(lib: ctypes.CDLL, v, areas, tb, cfg,
           out: Dict[str, torch.Tensor]) -> int:
    """One launch on the current stream over checked inputs (1 <= P,
    1 <= C <= :data:`MAX_C`) into :func:`empty_outputs`; the launcher's
    CUDA error code."""
    layout = (ctypes.c_int * len(LAYOUT))(*LAYOUT)
    ptrs = (ctypes.c_void_p * len(out))(*(t.data_ptr() for t in out.values()))
    return lib.topology_launch(
        v.data_ptr(), v.shape[1], areas.data_ptr(), v.shape[0], cfg.C,
        tb["m_bw"].data_ptr(), cfg.M, tb["p25"].data_ptr(),
        tb["p25_interp"].data_ptr(), cfg.n_pairs25, tb["p3"].data_ptr(),
        cfg.n_pairs3, cfg.acost, int(cfg.hop_uniform is None), layout, ptrs,
        torch.cuda.current_stream().cuda_stream)


def topology(v: torch.Tensor, areas: torch.Tensor, tb, cfg):
    """The topology dict of an encoded population, with the keys, dtypes
    and shapes of :func:`~repro_torch.kernels.topology.ref.
    topology_plain`; see the module docstring."""
    _check(v, areas, tb, cfg)
    if v.device.type == "cpu":
        return topology_plain(v, areas, tb, cfg)
    if v.device.type != "cuda":
        raise ValueError(f"topology: unsupported device {v.device}")
    if not 1 <= cfg.C <= MAX_C:
        raise ValueError(f"topology: C = {cfg.C} outside [1, {MAX_C}]")
    out = empty_outputs(v.shape[0], cfg.C, cfg.L, v.device)
    if v.shape[0]:
        lib = build()
        with torch.cuda.device(v.device):
            err = launch(lib, v, areas, tb, cfg, out)
        if err != 0:
            raise RuntimeError(f"topology kernel launch failed: CUDA error "
                               f"{err}")
        topology.launches += 1
    n_f, m_f, cl_f, y25, y3, cfp3 = out["row_f"].unbind(1)
    is25, is3d, ishyb = out["row_b"].unbind(1)
    bond_y, p3_bonded = bonding(out["is2d"], is25, is3d, ishyb, n_f, m_f,
                                cl_f, y25, y3, cfp3, out["a_bond"])
    return dict(
        eff_bw=out["eff_bw"], dram_e=out["dram_e"], hops=out["hops"],
        hops3=out["hops3"], link_bw=out["link_bw"], link_e=out["link_e"],
        inc=out["inc_s"].transpose(1, 2), pkg_area=out["pkg_area"],
        bond_y=bond_y, assembly=out["assembly"], interp=out["interp"],
        p25_rate=out["p25_rate"], p3_bonded=p3_bonded, is2d=out["is2d"],
        dest=out["dest"])


reset_launch_count()
