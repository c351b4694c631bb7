#!/usr/bin/env python3
"""Where the time of one RG-LRU decode step goes, on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 scripts/rglru_decode_probe.py

At the ``serve_hybrid`` decode shape (B = 4, T = 1, C = 4096, a start
state updated in place) it times, each as the per-call time of 50 calls
captured in one CUDA graph (``chip_smoke.graph_ms``): the launch floor
(``chip_smoke.phase_launch_floor``), the committed launcher
``rglru_launch``, and the variants of ``scripts/rglru_decode_probe.cu``:
an empty kernel, a float4 copy (one load, one store), the committed step
kernel at 32 to 512 threads a block, without the start state, without
the final state, with the state not aliased, and one element a thread
(128 blocks of 128 threads, the geometry of the kernel it replaced;
``scripts/kernel_ab.py`` times that kernel itself). Every variant that computes the
step is first held bitwise against ``rglru_plain``. After one untimed
graph, the list is timed twice, the second time in reverse order. Prints the card's line and one
JSON line per timing; exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "scripts" / "rglru_decode_probe.cu"
B, C = 4, 4096

# (name, variant, threads, start state, final state: "alias", "apart" or
# None, computes the step)
VARIANTS = (
    ("empty", 0, 128, False, None, False),
    ("copy", 1, 128, False, None, False),
    *((f"step_t{t}", 2, t, True, "alias", True) for t in (32, 64, 128, 256,
                                                           512)),
    ("step_t128_no_h0", 2, 128, False, "apart", True),
    ("step_t128_no_h_out", 2, 128, True, None, True),
    ("step_t128_apart", 2, 128, True, "apart", True),
    ("step_scalar_t128", 3, 128, True, "alias", True),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_decode_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru import rglru_plain

    card = cs.card_line()
    # the library's name hashes the probe's source only, not the kernel
    # source it includes: build it anew every run
    _build.library_path(PROBE).unlink(missing_ok=True)
    (so,) = _build.compile_sources([PROBE])
    lib = ctypes.CDLL(str(so))
    lib.probe_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.probe_launch.restype = ctypes.c_int
    committed = rops.build()
    cs.phase_launch_floor(card)
    a, b, h0 = cs.rglru_inputs(B, 1, C, True, seed=1)
    h_p, t_p = rglru_plain(a, b, h0)
    h = torch.empty_like(a)
    apart = torch.empty((B, C), device="cuda")

    def call(variant, threads, with_h0, final, state):
        out = {"alias": state, "apart": apart, None: None}[final]
        ptr = (lambda x: None if x is None else x.data_ptr())  # noqa: E731
        rc = lib.probe_launch(variant, threads, a.data_ptr(), b.data_ptr(),
                              ptr(state if with_h0 else None), h.data_ptr(),
                              ptr(out), B, C,
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"probe variant {variant} failed: CUDA error "
                               f"{rc}")
        return out

    for name, variant, threads, with_h0, final, computes in VARIANTS:
        if not computes:
            continue
        state = h0.clone()
        out = call(variant, threads, with_h0, final, state)
        torch.cuda.synchronize()
        want_h, want_t = (h_p, t_p) if with_h0 else rglru_plain(a, b)
        ok = torch.equal(h, want_h) and (
            out is None or torch.equal(out, want_t))
        if not ok:
            raise AssertionError(f"rglru decode probe: {name} != plain")

    state = h0.clone()

    def committed_launch():
        rc = committed.rglru_launch(
            a.data_ptr(), b.data_ptr(), state.data_ptr(), h.data_ptr(),
            state.data_ptr(), B, 1, C, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rglru_launch failed: CUDA error {rc}")

    timed = [("committed", committed_launch)] + [
        (name, (lambda v=v, t=t, w=w, f=f: call(v, t, w, f, state)))
        for name, v, t, w, f, _ in VARIANTS]
    cs.graph_ms(committed_launch)     # the first graph of a run reads low
    for turn, order in enumerate((timed, timed[::-1])):
        for name, fn in order:
            ms = cs.graph_ms(fn)
            cs.emit(dict(probe="rglru_decode", turn=turn, variant=name, B=B,
                         T=1, C=C, ms=ms, over_floor=ms - cs.FLOOR["ms"],
                         card=card))
    print(card)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
