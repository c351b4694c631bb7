#!/usr/bin/env python3
"""``prefix_select``, ``rglru`` and ``prefix_segment`` of another checkout
against this one's, on one card, in one process.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 scripts/kernel_ab.py BASE

BASE is another checkout of the repository (for example the parent
commit, unpacked with ``git archive HEAD | tar -x -C build/parent``).
The script builds ``prefix_select.cu``, ``rglru.cu`` and
``prefix_segment.cu`` from BASE and from this checkout (``nvcc``,
sm_90a, into ``build/kernels/``) and, at every shape of
``chip_smoke.py``'s phases ``kernel`` (both layouts, P in
``KERNEL_PS``), ``rglru_kernel`` (``RGLRU_SHAPES``) and
``prefix_segment_kernel`` (``segment_cases``, and the workload-1 int64
case at P = 512 again with index tensors 4 bytes past an 8-byte
boundary), on the same inputs, holds each library's output bitwise
against the plain torch version and times it as ``chip_smoke.graph_ms``
does (50 launches in one CUDA graph), in the order base, change, change,
base. Both libraries are called through the launch signatures they
share. Prints the card's line and one JSON line per timing (``tree``
"base" or "change", ``turn`` 0-3); exits non-zero if an output differs
or without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"prefix_select": "src/repro_torch/kernels/prefix_gather/csrc/"
                            "prefix_select.cu",
           "rglru": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
           "prefix_segment": "src/repro_torch/kernels/prefix_gather/csrc/"
                             "prefix_segment.cu"}
ORDER = ("base", "change", "change", "base")


def _libs(base: Path, build):
    """``{(kernel, tree): library}``, built from both checkouts."""
    keys = [(k, t) for k in KERNELS for t in ("base", "change")]
    sources = [(base if t == "base" else ROOT) / KERNELS[k] for k, t in keys]
    libs = {}
    for key, so in zip(keys, build.compile_sources(sources)):
        lib = ctypes.CDLL(str(so))
        if key[0] == "prefix_select":
            lib.prefix_select_launch.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 3)
            lib.prefix_select_launch.restype = ctypes.c_int
        elif key[0] == "prefix_segment":
            lib.prefix_segment_launch.argtypes = (
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                + [ctypes.c_int, ctypes.c_void_p])
            lib.prefix_segment_launch.restype = ctypes.c_int
        else:
            lib.rglru_launch.argtypes = ([ctypes.c_void_p] * 5
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
            lib.rglru_launch.restype = ctypes.c_int
        libs[key] = lib
    return libs


def _compare(cs, name, case, launchers, outs, want, card):
    """Time each tree's launch in ORDER after checking its outputs."""
    for turn, tree in enumerate(ORDER):
        launch = launchers[tree]
        for o in outs:
            o.zero_()
        launch()
        torch.cuda.synchronize()
        equal = all(torch.equal(o, w) for o, w in zip(outs, want))
        if not equal:
            raise AssertionError(f"{name} ({tree}) != plain at {case}")
        cs.emit(dict(ab=name, **case, tree=tree, turn=turn, equal=equal,
                     ms=cs.graph_ms(launch), card=card))


def _offset(x, elems: int = 1):
    """``x`` copied into a contiguous view ``elems`` int32 past the start
    of a fresh buffer: the base is 4-byte but not 8-byte aligned."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    view = buf[elems:].view(x.shape)
    view.copy_(x)
    return view


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.prefix_gather import (
        prefix_segment_plain,
        prefix_select_plain,
    )
    from repro_torch.kernels.rglru import rglru_plain

    card = cs.card_line()
    libs = _libs(args.base.resolve(), _build)
    cs.phase_launch_floor(card)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    for layout in ("single", "stacked"):
        for P in cs.KERNEL_PS:
            a = cs.kernel_inputs(layout, P, seed=P, dev=cs.DEV)
            p0, p1, rows, start, end, split, t0, t1 = a
            Pn, C = rows.shape
            F = p0.shape[0]
            sel = torch.empty((Pn, C, F), dtype=torch.int64, device=cs.DEV)
            tot = torch.empty((Pn, F), dtype=torch.int64, device=cs.DEV)

            def launcher(lib):
                def launch():
                    rc = lib.prefix_select_launch(
                        p0.data_ptr(), p1.data_ptr(), p0.shape[1],
                        p0.shape[2], p1.shape[2], F, rows.data_ptr(),
                        start.data_ptr(), end.data_ptr(), split.data_ptr(),
                        t0.data_ptr(), t1.data_ptr(), Pn, C, sel.data_ptr(),
                        tot.data_ptr(), stream())
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")
                return launch

            _compare(cs, "prefix_select", dict(layout=layout, P=P),
                     {t: launcher(libs["prefix_select", t])
                      for t in ("base", "change")},
                     (sel, tot), prefix_select_plain(*a), card)

    for shape, (B, T, C), with_state in cs.RGLRU_SHAPES:
        a, b, h0 = cs.rglru_inputs(B, T, C, with_state, seed=T)
        h_p, t_p = rglru_plain(a, b, h0)
        h = torch.empty_like(a)
        h_out = torch.empty((B, C), device=cs.DEV)
        h0_ptr = None if h0 is None else h0.data_ptr()

        def launcher(lib):
            def launch():
                rc = lib.rglru_launch(a.data_ptr(), b.data_ptr(), h0_ptr,
                                      h.data_ptr(), h_out.data_ptr(), B, T,
                                      C, stream())
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return launch

        _compare(cs, "rglru", dict(shape=shape, B=B, T=T, C=C),
                 {t: launcher(libs["rglru", t]) for t in ("base", "change")},
                 (h, h_out), (h_p, t_p), card)
        del a, b, h0, h_p, t_p, h, h_out

    cases = cs.segment_cases()
    name, pref, rows, start, end = cases[0]          # wl1-int64-P512
    cases.append((f"{name}-offset4", pref,
                  *(_offset(x) for x in (rows, start, end))))
    for name, pref, rows, start, end in cases:
        P, C = rows.shape
        diff = torch.empty((P, C), dtype=pref.dtype, device=cs.DEV)
        total = torch.empty((P,), dtype=pref.dtype, device=cs.DEV)
        code = kops.SEGMENT_DTYPES[pref.dtype]

        def launcher(lib):
            def launch():
                rc = lib.prefix_segment_launch(
                    pref.data_ptr(), pref.shape[1], rows.data_ptr(),
                    start.data_ptr(), end.data_ptr(), P, C,
                    diff.data_ptr(), total.data_ptr(), code, stream())
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return launch

        _compare(cs, "prefix_segment", dict(case=name, P=P, C=C),
                 {t: launcher(libs["prefix_segment", t])
                  for t in ("base", "change")},
                 (diff, total), prefix_segment_plain(pref, rows, start, end),
                 card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
