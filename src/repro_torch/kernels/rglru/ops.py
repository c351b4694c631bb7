"""Wrapper, build and launch count of the ``rglru`` CUDA kernel.

:func:`rglru` runs the RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``
over (B, T, C) (see :mod:`repro_torch.kernels.rglru.ref` for the
function). On a CUDA tensor it launches a hand-written Hopper kernel
in ``csrc/rglru.cu`` (its launcher takes the ring kernel for T >= 2, the
step kernel for one step; :func:`geometry` says which); on a CPU tensor
it runs the plain torch version
(:func:`~repro_torch.kernels.rglru.ref.rglru_plain`); on a ``meta``
tensor it returns empty outputs of the right shapes (shape-only
counting). There is no other switch, and a failed build or launch
raises. While a step is counted, each call reports its work
(:func:`work`) to the counters (``_build.COUNTERS``), whichever path
runs.

The final state is written into ``h_out`` (B, C), which may be ``h0``
itself: the decode cache's ``h`` slab is then updated in place. Any
T >= 1 and C >= 1 run as they are, with no padding.

Gradients. When ``a``, ``b`` or ``h0`` requires grad, the call goes
through an autograd node whose backward runs the adjoint recurrence

    lam_T = g_T + g_fin,   lam_t = g_t + a_{t+1} lam_{t+1}

(``g`` the gradient of h, ``g_fin`` that of the returned h_T), which is
the same recurrence run backward in time: the same kernel (or plain
version) over the reversed sequence with ``a`` shifted by one step,
from ``g_fin`` as its start state. Then ``db = lam``, ``da_t = lam_t
h_{t-1}`` (``h_0`` the start state) and ``dh0 = a_1 lam_1``. Such a call
refuses ``h_out``: the in-place write is the decode path's.

The kernel is built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, under ``build/kernels/``) at first use and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.rglru_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geo = lib.rglru_geometry
    geo.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    geo.restype = None


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def geometry(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             h: Optional[torch.Tensor] = None,
             h_out: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """The launch the built library makes for these tensors (``h``
    None: a fresh, aligned output): ``kernel`` ("ring" or "step"),
    ``access_bytes`` a thread's load (16 or 4: the ring's cp.async width,
    the step kernel's float4 or scalar), grid, ``threads`` and static
    ``smem_bytes`` a block, ring ``steps_per_stage`` and ``stages``."""
    out = (ctypes.c_int * 8)()
    bsz, t, c = a.shape
    build().rglru_geometry(*(None if x is None else x.data_ptr()
                             for x in (a, b, h0, h, h_out)), bsz, t, c, out)
    kernel, vec, gx, gy, threads, smem, tc, stages = out
    return dict(kernel="step" if kernel else "ring",
                access_bytes=16 if vec else 4, grid=[gx, gy],
                blocks=gx * gy, threads=threads, smem_bytes=smem,
                steps_per_stage=tc, stages=stages)


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return rglru.launches


def reset_launch_count() -> None:
    rglru.launches = 0


def _check(a, b, h0, h_out):
    ts = [x for x in (a, b, h0, h_out) if x is not None]
    if any(x.device != a.device for x in ts):
        raise ValueError("rglru: all tensors must share one device")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError("rglru: every tensor must be float32, got "
                        f"{[str(x.dtype) for x in ts]}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError("rglru: a and b must be one (B, T, C) shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    bsz, t, c = a.shape
    if min(bsz, t, c) < 1:
        raise ValueError(f"rglru: need B, T, C >= 1, got {tuple(a.shape)}")
    for name, h in (("h0", h0), ("h_out", h_out)):
        if h is not None and h.shape != (bsz, c):
            raise ValueError(f"rglru: {name} must be ({bsz}, {c}), got "
                             f"{tuple(h.shape)}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("rglru: tensors must be contiguous")


def work(a: torch.Tensor,
         h0: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(operations, bytes) of one call: the least work the function
    needs, as the counter (:mod:`repro_torch.analysis.counting`) and the
    kernel's bound read it. Bytes: a and b read once, the start state
    (when given) read once, h and the final state written once.
    Operations: one multiply and one add per element."""
    B, T, C = a.shape
    nbytes = 4 * (3 * B * T * C + B * C + (B * C if h0 is not None else 0))
    return 2 * B * T * C, nbytes


def _run(a, b, h0, h_out):
    """The recurrence on the inputs' device: the kernel on cuda, the
    plain version on the CPU, empty outputs of the right shapes on
    ``meta`` (nothing is launched). Its work (:func:`work`) is reported to
    the counters while a step is counted, whichever runs."""
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rglru: unsupported device {a.device}")
    if _build.COUNTERS:
        with _build.counted("rglru", *work(a, h0)):
            return _compute(a, b, h0, h_out)
    return _compute(a, b, h0, h_out)


def _compute(a, b, h0, h_out):
    if a.device.type == "cpu":
        h, h_t = rglru_plain(a, b, h0)
        if h_out is not None:
            h_t = h_out.copy_(h_t)
        return h, h_t
    if a.device.type == "meta":
        h_t = h_out if h_out is not None else torch.empty(
            a.shape[::2], dtype=torch.float32, device=a.device)
        return torch.empty_like(a), h_t
    return _launch(a, b, h0, h_out)


def _launch(a, b, h0, h_out):
    lib = build()
    bsz, t, c = a.shape
    h = torch.empty_like(a)
    h_t = h_out if h_out is not None else torch.empty(
        (bsz, c), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_t.data_ptr(), bsz, t, c, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru.launches += 1
    return h, h_t


def _adjoint(a: torch.Tensor, g: torch.Tensor,
            g_fin: torch.Tensor) -> torch.Tensor:
    """``lam`` (B, T, C) of the module docstring: the recurrence run over
    the reversed sequence, ``a`` shifted by one step (1 first, which
    carries the start state ``g_fin`` in exactly), on ``a``'s device."""
    a_rev = torch.cat([torch.ones_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
    lam_rev, _ = _run(a_rev, g.flip(1), g_fin.contiguous(), None)
    return lam_rev.flip(1)


class _RGLRU(torch.autograd.Function):
    """The recurrence with gradients in ``a``, ``b`` and ``h0``: forward
    as :func:`rglru`; backward by :func:`_adjoint`."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_t = _run(a, b, h0, None)
        ctx.save_for_backward(a, h0, h)
        return h, h_t

    @staticmethod
    @once_differentiable
    def backward(ctx, g, g_fin):
        a, h0, h = ctx.saved_tensors
        lam = _adjoint(a, g, g_fin)
        start = torch.zeros_like(a[:, :1]) if h0 is None else h0[:, None]
        da = lam * torch.cat([start, h[:, :-1]], dim=1)
        dh0 = None if h0 is None else a[:, 0] * lam[:, 0]
        return da, lam, dh0


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None, *,
          h_out: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h (B, T, C), h_T (B, C))`` float32 from ``a, b`` (B, T, C) and
    the start state ``h0`` (B, C) (zeros when None). The final state is
    written into ``h_out`` when it is given (it may be ``h0`` itself)
    and returned. When an input requires grad the result takes
    gradients (module docstring), and ``h_out`` is refused."""
    _check(a, b, h0, h_out)
    if any(x is not None and x.requires_grad for x in (a, b, h0)):
        if h_out is not None:
            raise ValueError("rglru: h_out (the in-place decode write) is "
                             "refused when an input requires grad")
        return _RGLRU.apply(a, b, h0)
    return _run(a, b, h0, h_out)


rglru.launches = 0
