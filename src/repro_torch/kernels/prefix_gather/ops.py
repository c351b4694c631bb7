"""Wrappers, builds and launch counts of the prefix-table gather kernels.

:func:`prefix_select` is the tempering evaluator's whole prefix-table
stage: both split-K gathers for all sim metrics, the per-row clip to the
true tile totals, the split select and the per-slot segment reduction.
On a CUDA tensor it launches a hand-written Hopper kernel in
``csrc/prefix_select.cu`` (its launcher takes the one-output-a-thread
kernel for 1 <= C*F <= 128, the looping kernel otherwise;
:func:`geometry` says which); on a CPU tensor it runs the plain torch
version (:func:`~repro_torch.kernels.prefix_gather.ref.
prefix_select_plain`). There is no other switch, and a failed build or
launch raises.

:func:`prefix_segment_gather` is the single-table form: per-slot
differences of one ``[R, T+1]`` table and their per-system totals, with
no clipping. It launches ``csrc/prefix_segment.cu`` on a CUDA tensor
(a thread per slot; its launcher takes the kernel with C at compile
time for 1 <= C <= 8, the grouped kernel otherwise;
:func:`segment_geometry` says which) and runs
:func:`~repro_torch.kernels.prefix_gather.ref.prefix_segment_plain` on a
CPU tensor, the same way. It counts its launches by kernel in
``prefix_segment_gather.path_launches``.

Each kernel is built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, under ``build/kernels/``) at first use and loaded with
``ctypes``; the two sources build apart.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_gather.ref import (
    prefix_segment_plain,
    prefix_select_plain,
)
from repro_torch.runtime import trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefix_select.cu"
SEGMENT_SOURCE = Path(__file__).resolve().parent / "csrc" / "prefix_segment.cu"
# the table dtypes prefix_segment_gather takes, by the kernel's type code
SEGMENT_DTYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2,
                  torch.int32: 3}
SEGMENT_PATHS = ("unrolled", "grouped")


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.prefix_select_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    geo = lib.prefix_select_geometry
    geo.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    geo.restype = None


def _configure_segment(lib: ctypes.CDLL) -> None:
    fn = lib.prefix_segment_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geo = lib.prefix_segment_geometry
    geo.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    geo.restype = None


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def build_segment() -> ctypes.CDLL:
    """Compile and load the ``prefix_segment`` kernel library."""
    return _build.load(SEGMENT_SOURCE, _configure_segment)


def geometry(P: int, C: int, F: int) -> Dict[str, object]:
    """The ``prefix_select`` launch of the built library for P systems
    of C slots and F metrics: ``kernel`` ("one", one output a thread, or
    "loop"), ``blocks``, ``block`` dimensions, ``systems`` a block and
    dynamic ``smem_bytes`` a block."""
    out = (ctypes.c_int * 7)()
    build().prefix_select_geometry(P, C, F, out)
    kernel, blocks, bx, by, bz, systems, smem = out
    return dict(kernel="loop" if kernel else "one", blocks=blocks,
                block=[bx, by, bz], systems=systems, smem_bytes=smem)


def segment_geometry(P: int, C: int) -> Dict[str, object]:
    """The ``prefix_segment`` launch of the built library for P systems
    of C slots: ``kernel`` ("unrolled", C at compile time, or "grouped"),
    ``blocks``, ``threads`` a block and ``systems`` a warp (a thread per
    slot)."""
    out = (ctypes.c_int * 4)()
    build_segment().prefix_segment_geometry(P, C, out)
    kernel, blocks, threads, systems = out
    return dict(kernel=SEGMENT_PATHS[kernel], blocks=blocks, threads=threads,
                systems=systems)


def launch_count() -> int:
    """``prefix_select`` launches since the last
    :func:`reset_launch_count`."""
    return prefix_select.launches


def segment_launch_count() -> int:
    """``prefix_segment`` launches since the last
    :func:`reset_launch_count`."""
    return prefix_segment_gather.launches


def reset_launch_count() -> None:
    prefix_select.launches = 0
    prefix_segment_gather.launches = 0
    prefix_segment_gather.path_launches = dict.fromkeys(SEGMENT_PATHS, 0)


def _check(pref0, pref1, rows, start, end, split, t0, t1):
    dev = pref0.device
    ts = (pref0, pref1, rows, start, end, split, t0, t1)
    if any(x.device != dev for x in ts):
        raise ValueError("prefix_select: all tensors must share one device")
    if pref0.dtype != torch.int64 or pref1.dtype != torch.int64:
        raise TypeError("prefix_select: tables must be int64, got "
                        f"{pref0.dtype}/{pref1.dtype}")
    if any(x.dtype != torch.int32 for x in ts[2:]):
        raise TypeError("prefix_select: indices and bounds must be int32")
    if pref0.dim() != 3 or pref1.dim() != 3 or \
            pref0.shape[:2] != pref1.shape[:2]:
        raise ValueError("prefix_select: tables must be [F, R, T+1] with "
                         f"equal F, R; got {tuple(pref0.shape)}, "
                         f"{tuple(pref1.shape)}")
    if rows.dim() != 2 or start.shape != rows.shape or \
            end.shape != rows.shape:
        raise ValueError("prefix_select: rows/start/end must be one [P, C] "
                         "shape")
    P = rows.shape[0]
    if any(x.shape != (P,) for x in (split, t0, t1)):
        raise ValueError("prefix_select: split/t0/t1 must be [P]")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("prefix_select: tensors must be contiguous")
    if P == 0:
        return
    R, t0b, t1b = pref0.shape[1], pref0.shape[2], pref1.shape[2]
    bad = ((t0.min() < 0) | (t0.max() > t0b - 1) | (t1.min() < 0)
           | (t1.max() > t1b - 1))
    if rows.numel():
        bad = bad | (rows.min() < 0) | (rows.max() >= R)
    if bool(trace.fetch(bad, "check")):
        raise ValueError("prefix_select: a row index lies outside [0, R) "
                         "or a clip bound outside [0, T_b - 1]")


def prefix_select(pref0: torch.Tensor, pref1: torch.Tensor,
                  rows: torch.Tensor, start: torch.Tensor,
                  end: torch.Tensor, split: torch.Tensor,
                  t0: torch.Tensor, t1: torch.Tensor):
    """``(sel [P, C, F], total [P, F])`` int64 — see the module docstring
    and :func:`~repro_torch.kernels.prefix_gather.ref.
    prefix_select_plain` for the arguments."""
    _check(pref0, pref1, rows, start, end, split, t0, t1)
    if pref0.device.type == "cpu":
        return prefix_select_plain(pref0, pref1, rows, start, end, split,
                                   t0, t1)
    if pref0.device.type != "cuda":
        raise ValueError(f"prefix_select: unsupported device {pref0.device}")
    lib = build()
    F, R, t0b = pref0.shape
    t1b = pref1.shape[2]
    P, C = rows.shape
    sel = torch.empty((P, C, F), dtype=torch.int64, device=pref0.device)
    total = torch.empty((P, F), dtype=torch.int64, device=pref0.device)
    with torch.cuda.device(pref0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prefix_select_launch(
            pref0.data_ptr(), pref1.data_ptr(), R, t0b, t1b, F,
            rows.data_ptr(), start.data_ptr(), end.data_ptr(),
            split.data_ptr(), t0.data_ptr(), t1.data_ptr(), P, C,
            sel.data_ptr(), total.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"prefix_select kernel launch failed: CUDA error "
                           f"{err}")
    prefix_select.launches += 1
    return sel, total


def _check_segment(pref, rows, start, end):
    """The indices as int32 and contiguous, after checking every index
    against the table (the TPU kernel reads them unchecked)."""
    ts = (pref, rows, start, end)
    if any(x.device != pref.device for x in ts):
        raise ValueError("prefix_segment_gather: all tensors must share one "
                         "device")
    if pref.dtype not in SEGMENT_DTYPES:
        raise TypeError("prefix_segment_gather: the table must be float64, "
                        f"float32, int64 or int32, got {pref.dtype}")
    if any(x.dtype.is_floating_point or x.dtype.is_complex
           or x.dtype == torch.bool for x in ts[1:]):
        raise TypeError("prefix_segment_gather: rows/start/end must be "
                        "integer tensors")
    if pref.dim() != 2 or not pref.is_contiguous():
        raise ValueError("prefix_segment_gather: the table must be a "
                         f"contiguous [R, T+1]; got {tuple(pref.shape)}")
    if rows.dim() != 2 or start.shape != rows.shape or \
            end.shape != rows.shape:
        raise ValueError("prefix_segment_gather: rows/start/end must be one "
                         "[P, C] shape")
    if rows.shape[1] == 0:
        raise ValueError("prefix_segment_gather: need C >= 1 slots")
    R, T1 = pref.shape
    if rows.numel():
        bad = (rows.min() < 0) | (rows.max() >= R)
        for idx in (start, end):
            bad = bad | (idx.min() < 0) | (idx.max() >= T1)
        if bool(bad):
            raise ValueError("prefix_segment_gather: a row index lies "
                             f"outside [0, {R}) or a tile index outside "
                             f"[0, {T1 - 1}]")
    return tuple(x.to(torch.int32).contiguous() for x in ts[1:])


def prefix_segment_gather(pref: torch.Tensor, rows: torch.Tensor,
                          start: torch.Tensor, end: torch.Tensor):
    """``(diff [P, C], total [P])`` in ``pref.dtype``: per-slot prefix
    differences of the ``[R, T+1]`` table and their per-system totals
    (see :func:`~repro_torch.kernels.prefix_gather.ref.
    prefix_segment_plain`). Indices of any integer dtype are cast to
    int32, as the reference casts them."""
    rows, start, end = _check_segment(pref, rows, start, end)
    if pref.device.type == "cpu":
        return prefix_segment_plain(pref, rows, start, end)
    if pref.device.type != "cuda":
        raise ValueError("prefix_segment_gather: unsupported device "
                         f"{pref.device}")
    P, C = rows.shape
    diff = torch.empty((P, C), dtype=pref.dtype, device=pref.device)
    total = torch.empty((P,), dtype=pref.dtype, device=pref.device)
    if P == 0:
        return diff, total
    lib = build_segment()
    with torch.cuda.device(pref.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prefix_segment_launch(
            pref.data_ptr(), pref.shape[1], rows.data_ptr(),
            start.data_ptr(), end.data_ptr(), P, C, diff.data_ptr(),
            total.data_ptr(), SEGMENT_DTYPES[pref.dtype], stream)
    if err != 0:
        raise RuntimeError(f"prefix_segment kernel launch failed: CUDA "
                           f"error {err}")
    prefix_segment_gather.launches += 1
    # the launcher dispatches on the plan that the geometry reports
    path = segment_geometry(P, C)["kernel"]
    prefix_segment_gather.path_launches[path] += 1
    return diff, total


reset_launch_count()
