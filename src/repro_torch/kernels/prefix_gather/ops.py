"""Wrapper, build and launch count of the ``prefix_select`` CUDA kernel.

:func:`prefix_select` is the tempering evaluator's whole prefix-table
stage: both split-K gathers for all sim metrics, the per-row clip to the
true tile totals, the split select and the per-slot segment reduction.
On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/prefix_select.cu``; on a CPU tensor it runs the plain torch
version (:func:`~repro_torch.kernels.prefix_gather.ref.
prefix_select_plain`). There is no other switch, and a failed build or
launch raises.

The kernel is built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, under ``build/kernels/``) at first use and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_gather.ref import prefix_select_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefix_select.cu"


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.prefix_select_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return prefix_select.launches


def reset_launch_count() -> None:
    prefix_select.launches = 0


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
    if bool(bad):
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


prefix_select.launches = 0
