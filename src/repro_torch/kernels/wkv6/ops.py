"""Wrapper, build and launch count of the ``wkv6`` CUDA kernel.

:func:`wkv6` runs the RWKV-6 WKV recurrence over G = batch x heads rows
(see :mod:`repro_torch.kernels.wkv6.ref` for the function). On a CUDA
tensor it launches the hand-written Hopper kernel in ``csrc/wkv6.cu``;
on a CPU tensor it runs the plain torch version
(:func:`~repro_torch.kernels.wkv6.ref.wkv6_plain`); on a ``meta``
tensor it returns empty outputs of the right shapes (shape-only
counting). There is no other switch, and a failed build or launch
raises. While a step is counted, each call reports its work
(:func:`work`) to the counters (``_build.COUNTERS``), whichever path
runs.

Layouts. ``r, k, v, w`` are either (G, T, D) rows, or the model's
(B, T, H, D) with rows g = b*H + h, which the kernel reads and writes as
they lie (y comes back in the inputs' layout). ``u`` is read as row
``g % H_u``: the model passes its per-head ``u`` of shape (H, D) as it
is, a row stride of 0 over the batch, and nothing is expanded. The state
is indexed [g, k, v]: (G, D, D) beside 3-D inputs, (B, H, D, D) beside
4-D ones, which is the decode cache's slab as it lies in memory;
``s_out`` may be that same slab, and the update is then in place.

Gradients. When an input requires grad, the call goes through an
autograd node: its forward is the kernel (the plain version on the
CPU), and its backward, :func:`_wkv6_vjp_plain`, recomputes the plain
recurrence from the saved inputs under autograd and takes its
vector-Jacobian product. Neither this package nor the JAX package has a
backward kernel for WKV (the JAX package trains through its
``lax.scan``); the recompute holds every step's (G, D, D) intermediates
of one call and makes a few launches a step. Such a call refuses
``s_out``: the in-place write is the decode path's.

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
from repro_torch.kernels.wkv6.ref import wkv6_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
SUPPORTED_D = (64,)          # the model's HEAD_DIM; the kernel is built for it


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv6_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_geometry.restype = None


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def geometry(G: int) -> Dict[str, int]:
    """The kernel's launch geometry for G rows, as the built library
    reports it: grid ``blocks``, ``threads`` a block, value columns per
    block ``VB``, lanes sharing a column group ``P``, steps per chunk
    ``CT``, ring ``stages`` and static shared ``smem_bytes`` a block."""
    out = (ctypes.c_int * 6)()
    build().wkv6_geometry(out)
    vb, p, ct, stages, threads, smem = out
    return dict(blocks=G * SUPPORTED_D[0] // vb, threads=threads, VB=vb,
                P=p, CT=ct, stages=stages, smem_bytes=smem)


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return wkv6.launches


def reset_launch_count() -> None:
    wkv6.launches = 0


def _check(r, k, v, w, u, s0, s_out):
    """Validate the arguments; return (B, T, H, D), with B = G and H = 1
    for (G, T, D) inputs, and the state's shape."""
    dev = r.device
    ts = [x for x in (r, k, v, w, u, s0, s_out) if x is not None]
    if any(x.device != dev for x in ts):
        raise ValueError("wkv6: all tensors must share one device")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError("wkv6: every tensor must be float32, got "
                        f"{[str(x.dtype) for x in ts]}")
    if r.dim() not in (3, 4) or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError("wkv6: r, k, v, w must be one (G, T, D) or "
                         "(B, T, H, D) shape; got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    if r.dim() == 3:
        b, t, d = r.shape
        h = 1
        heads, state = b, (b, d, d)
    else:
        b, t, h, d = r.shape
        heads, state = h, (b, h, d, d)
    if d not in SUPPORTED_D:
        raise ValueError(f"wkv6: D = {d} is not supported (D in "
                         f"{SUPPORTED_D})")
    if b < 1 or h < 1 or t < 1:
        raise ValueError(f"wkv6: need rows and T >= 1, got {tuple(r.shape)}")
    if u.dim() != 2 or u.shape[1] != d or u.shape[0] < 1 or \
            heads % u.shape[0]:
        what = "G" if r.dim() == 3 else "H"
        raise ValueError(f"wkv6: u must be (H_u, {d}) with {what}={heads} a "
                         f"multiple of H_u; got {tuple(u.shape)}")
    for name, s in (("s0", s0), ("s_out", s_out)):
        if s is not None and s.shape != state:
            raise ValueError(f"wkv6: {name} must be {state}, got "
                             f"{tuple(s.shape)}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("wkv6: tensors must be contiguous")
    return (b, t, h, d), state


def work(r: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(operations, bytes) of one call: the least work the function
    needs, as the counter (:mod:`repro_torch.analysis.counting`) and the
    kernel's bound read it. Bytes: r, k, v, w read once, u and the start
    state (when given) read once, y and S_T written once. Operations per
    (g, t): y_v = sum_k r_k S[k, v] + v_v sum_k r_k u_k k_k (2 D^2 + 5 D)
    and S <- w * S + k v^T (3 D^2). ``r`` is (G, T, D) or
    (B, T, H, D)."""
    T, D = r.shape[1], r.shape[-1]
    G = r.numel() // (T * D)
    nbytes = 4 * (5 * G * T * D + u.numel() + G * D * D
                  + (G * D * D if s0 is not None else 0))
    return G * T * (5 * D * D + 5 * D), nbytes


def _run(r, k, v, w, u, s0, s_out, b, t, h, d, state):
    """The recurrence on the inputs' device: the kernel on cuda, the
    plain version on the CPU, empty outputs of the right shapes on
    ``meta`` (nothing is launched). Its work (:func:`work`) is reported to
    the counters while a step is counted, whichever runs."""
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if _build.COUNTERS:
        with _build.counted("wkv6", *work(r, u, s0)):
            return _compute(r, k, v, w, u, s0, s_out, b, t, h, d, state)
    return _compute(r, k, v, w, u, s0, s_out, b, t, h, d, state)


def _compute(r, k, v, w, u, s0, s_out, b, t, h, d, state):
    if r.device.type == "cpu":
        y, s = wkv6_plain(r, k, v, w, u, s0)
        if s_out is not None:
            s = s_out.copy_(s)
        return y, s
    if r.device.type == "meta":
        y = torch.empty_like(r)
        s = s_out if s_out is not None else torch.empty(
            state, dtype=torch.float32, device=r.device)
        return y, s
    return _launch(r, k, v, w, u, s0, s_out, b, t, h, d, state)


def _launch(r, k, v, w, u, s0, s_out, b, t, h, d, state):
    if any(x is not None and x.data_ptr() % 16
           for x in (r, k, v, w, u, s0, s_out)):
        raise ValueError("wkv6: r, k, v, w, u and the state must start on "
                         "16 bytes (the kernel moves them in 16-byte pieces)")
    lib = build()
    y = torch.empty_like(r)
    s = s_out if s_out is not None else torch.empty(
        state, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), u.shape[0],
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            s.data_ptr(), b, t, h, d, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, s


def _wkv6_vjp_plain(inputs, gy, gs, needs):
    """The gradients of ``(y, S_T)`` in ``inputs`` = (r, k, v, w, u, s0)
    under the cotangents ``gy``, ``gs``: the plain recurrence recomputed
    under autograd, then its vector-Jacobian product (plain torch, not a
    kernel). ``needs`` flags the inputs that take a gradient; the others
    get None."""
    with torch.enable_grad():
        xs = [None if x is None else x.detach().requires_grad_(need)
              for x, need in zip(inputs, needs)]
        y, s = wkv6_plain(*xs)
        want = [x for x, need in zip(xs, needs) if need]
        grads = iter(torch.autograd.grad((y, s), want, (gy, gs)))
    return tuple(next(grads) if need else None for need in needs)


class _WKV6(torch.autograd.Function):
    """The recurrence with gradients in r, k, v, w, u and s0: forward
    as :func:`wkv6`; backward by :func:`_wkv6_vjp_plain`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, geometry):
        y, s = _run(r, k, v, w, u, s0, None, *geometry)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gs):
        return _wkv6_vjp_plain(ctx.saved_tensors, gy, gs,
                               ctx.needs_input_grad[:6]) + (None,)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *,
         s_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, S_T)`` float32: y in the layout of ``r`` and the state as
    the module docstring lays it out — see
    :func:`~repro_torch.kernels.wkv6.ref.wkv6_plain` for the arguments.
    The final state is written into ``s_out`` when it is given (it may
    be ``s0`` itself) and returned. When an input requires grad the
    result takes gradients (module docstring), and ``s_out`` is
    refused."""
    (b, t, h, d), state = _check(r, k, v, w, u, s0, s_out)
    geometry = (b, t, h, d, state)
    if any(x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        if s_out is not None:
            raise ValueError("wkv6: s_out (the in-place decode write) is "
                             "refused when an input requires grad")
        return _WKV6.apply(r, k, v, w, u, s0, geometry)
    return _run(r, k, v, w, u, s0, s_out, *geometry)


wkv6.launches = 0
