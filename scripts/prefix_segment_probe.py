#!/usr/bin/env python3
"""Where the time of the single-table prefix gather goes, on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 scripts/prefix_segment_probe.py

At every case of ``chip_smoke.segment_cases`` it times, each as the
per-call time of 50 calls captured in one CUDA graph
(``chip_smoke.graph_ms``): the launch floor
(``chip_smoke.phase_launch_floor``), the committed launcher
``prefix_segment_launch``, and the variants of
``scripts/prefix_segment_probe.cu``, each at 32, 64 and 128 threads a
block: an empty kernel, the first load level alone with its stores, the
committed kernel for C, the committed grouped kernel (C at run time) at
every C, and the first design tried (a thread per system, the slots
unrolled); and the committed launcher once more on a fresh copy of the
table (the workload-1 tables are views into the stacked table of
``chip_smoke.kernel_inputs``, the others fresh allocations), to
show what the table's place in memory moves. Every variant that
computes the function is first held bitwise against
``prefix_segment_plain``. After one
untimed graph, each case's list is timed twice, the second time in
reverse order. Prints the card's line and one JSON line per timing;
exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "scripts" / "prefix_segment_probe.cu"
THREADS = (32, 64, 128)
# (name, variant, threads, computes the function, takes C > 8)
VARIANTS = (
    *((f"empty_t{t}", 0, t, False, True) for t in THREADS),
    *((f"indices_t{t}", 1, t, False, False) for t in THREADS),
    *((f"kernel_t{t}", 2, t, True, True) for t in THREADS),
    *((f"system_t{t}", 4, t, True, False) for t in THREADS),
    *((f"grouped_t{t}", 5, t, True, True) for t in THREADS),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("prefix_segment_probe: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.prefix_gather import prefix_segment_plain

    card = cs.card_line()
    # the library's name hashes the probe's source only, not the kernel
    # source it includes: build it anew every run
    _build.library_path(PROBE).unlink(missing_ok=True)
    (so,) = _build.compile_sources([PROBE])
    lib = ctypes.CDLL(str(so))
    lib.probe_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    lib.probe_launch.restype = ctypes.c_int
    committed = kops.build_segment()
    cs.phase_launch_floor(card)

    for name, pref, rows, start, end in cs.segment_cases():
        P, C = rows.shape
        code = kops.SEGMENT_DTYPES[pref.dtype]
        d_p, t_p = prefix_segment_plain(pref, rows, start, end)
        diff, total = torch.empty_like(d_p), torch.empty_like(t_p)
        args = (pref.data_ptr(), pref.shape[1], rows.data_ptr(),
                start.data_ptr(), end.data_ptr(), P, C, diff.data_ptr(),
                total.data_ptr(), code)

        def call(variant, threads):
            rc = lib.probe_launch(variant, threads, *args,
                                  torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe variant {variant} failed: CUDA "
                                   f"error {rc}")

        copy = pref.clone()

        def committed_launch(table=pref):
            rc = committed.prefix_segment_launch(
                table.data_ptr(), *args[1:],
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"prefix_segment_launch failed: CUDA "
                                   f"error {rc}")

        variants = [v for v in VARIANTS if v[4] or C <= 8]
        for vname, variant, threads, computes, _ in variants:
            if not computes:
                continue
            diff.zero_()
            total.zero_()
            call(variant, threads)
            torch.cuda.synchronize()
            if not (torch.equal(diff, d_p) and torch.equal(total, t_p)):
                raise AssertionError(f"prefix_segment probe: {vname} != "
                                     f"plain at {name}")

        diff.zero_()
        committed_launch(copy)
        torch.cuda.synchronize()
        if not (torch.equal(diff, d_p) and torch.equal(total, t_p)):
            raise AssertionError(f"prefix_segment probe: table copy != "
                                 f"plain at {name}")
        timed = [("committed", committed_launch),
                 ("committed_table_copy",
                  lambda: committed_launch(copy))] + [
            (vname, (lambda v=v, t=t: call(v, t)))
            for vname, v, t, _, _ in variants]
        cs.graph_ms(committed_launch)    # the first graph of a case reads low
        geo = kops.segment_geometry(P, C)
        for turn, order in enumerate((timed, timed[::-1])):
            for vname, fn in order:
                ms = cs.graph_ms(fn)
                cs.emit(dict(probe="prefix_segment", case=name, turn=turn,
                             variant=vname, P=P, C=C, geometry=geo, ms=ms,
                             over_floor=ms - cs.FLOOR["ms"], card=card))
    print(card)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
