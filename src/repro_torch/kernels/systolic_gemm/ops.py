"""Wrapper, build and launch counts of the systolic GEMM CUDA kernels.

:func:`systolic_gemm` is ``a @ b`` through the paper's mapping knobs
(Sec IV-A): the dataflow (OS, WS or IS), split-K and the tile
``(bm, bk, bn)``. It follows the reference wrapper step for step: the
same checks, zero-padding to tile multiples (and K to ``split_k * bk``
for split-K), the dataflow dispatch, the float32 slab sum, the cast to
``out_dtype`` and the ``[:m, :n]`` slice.

The four kernel-level functions, one per TPU kernel site, take operands
whose shapes are tile multiples. On CUDA tensors each launches its
hand-written Hopper kernel in ``csrc/systolic_gemm.cu``; on CPU tensors
each runs its plain torch version (:mod:`repro_torch.kernels.
systolic_gemm.ref`). There is no other switch, and a failed build or
launch raises.

Kernels. Each of the four sites takes one of two kernels, by
:func:`kernel_path`, a function of the dtype and the tile alone (the C
launcher is told the path and refuses a mismatch); each site counts its
launches per path in ``.path_launches``:

* ``"wgmma"``, for bfloat16 / float16 at ``bm``, ``bn`` in {64, 128} and
  ``bk % 16 == 0``: TMA loads into a ring of shared memory, tensor-core
  ``wgmma`` products into float32 accumulators in registers. For OS and
  split-K (replacing ``_os_kernel`` / ``_os_splitk_kernel``) the tensor
  cores bound it (0.030 ms at WL2 in 16-bit); both operands stream
  through one ring, the accumulator lives across all k-blocks, and the
  ring is sized so that two blocks share an SM, which hides one tile's
  epilogue behind another's products. For WS and IS (``_spill_kernel``)
  the float32 slab writes bound it; the resident block is loaded once
  and the slab tiles leave while the ring holds the next step.
* ``"simt"``, everything else: a double-buffered FFMA kernel in float32
  (no TF32), with 16-byte loads and four (OS at small tiles: two)
  16-byte shared reads per k, loaded a k ahead, bound by FFMA issue. For
  OS and split-K the thread block follows the tile: a 4 x 4 register
  block a thread while that takes at most 256 threads, else 8 x 8, so no
  lane idles at tiles under 128.

All paths of a site write the same outputs, and each is held against the
plain version on the card.

Tiles. ``bm`` and ``bn`` are multiples of 16 up to 128. ``bk`` is any
size whose shared memory (:func:`smem_bytes`) fits the 232,448 B a Hopper
block may use: for OS and split-K that is every ``bk`` (the footprint has
no ``bk`` term); WS and IS keep a whole ``bk``-deep block of their
stationary operand resident, so at ``bm = bn = 128`` WS takes ``bk`` up
to 388 and IS up to 378. The accepted set is the same on every device
and for every dtype; other tiles raise ``ValueError``.

The kernels are built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, under ``build/kernels/``) at first use and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.systolic_gemm.ref import (
    is_gemm_partials_plain,
    os_gemm_plain,
    os_gemm_splitk_plain,
    ws_gemm_partials_plain,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "systolic_gemm.cu"
DATAFLOWS = ("OS", "WS", "IS")
# operand dtypes the kernels take, by their type code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SIDE, MAX_SIDE = 16, 128       # as in the kernel source
CHUNK, PITCH_PAD = 32, 4       # simt path: kChunk, kPitchPad
PATHS = ("simt", "wgmma")      # by the launchers' path code
SMEM_LIMIT = 232448            # shared memory one Hopper block may opt into


def _configure(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.os_gemm_launch.argtypes = [p, p, p, i64, i64, i64, i, i, i, i, i, i,
                                   p]
    lib.os_gemm_splitk_launch.argtypes = [p, p, p, i64, i64, i64, i, i, i,
                                          i, i, i, p]
    for name in ("ws_gemm_partials_launch", "is_gemm_partials_launch"):
        getattr(lib, name).argtypes = [p, p, p, i64, i64, i64, i, i, i, i, i,
                                       p]
    for name in ("os_gemm_launch", "os_gemm_splitk_launch",
                 "ws_gemm_partials_launch", "is_gemm_partials_launch",
                 "systolic_gemm_init"):
        getattr(lib, name).restype = ctypes.c_int
    err = lib.systolic_gemm_init()
    if err != 0:
        raise RuntimeError(f"systolic_gemm: setting the shared memory limit "
                           f"failed: CUDA error {err}")


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    return _build.load(SOURCE, _configure)


def launch_count() -> int:
    """All four sites' launches since the last :func:`reset_launch_count`
    (each site keeps its own in ``.launches``)."""
    return sum(fn.launches for fn in KERNELS)


def reset_launch_count() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.path_launches = dict.fromkeys(PATHS, 0)


def smem_bytes(dataflow: str, bm: int, bk: int, bn: int) -> int:
    """Shared memory one block of the ``dataflow`` kernel takes on the
    simt path, which decides the accepted tiles on both paths (the WS/IS
    wgmma ring is sized to fit inside it; the OS one, like this, has no
    ``bk`` term). The same formulas as ``os_smem`` and ``spill_smem`` in
    ``csrc/systolic_gemm.cu``."""
    if dataflow == "WS":
        return 4 * (bk * bn + 2 * CHUNK * (bm + PITCH_PAD))
    if dataflow == "IS":
        return 4 * (bk * (bm + PITCH_PAD) + 2 * CHUNK * bn)
    return 4 * 2 * CHUNK * (bm + PITCH_PAD + bn)


def kernel_path(dtype, bm: int, bk: int, bn: int) -> str:
    """The kernel a call of any site runs on the card: ``"wgmma"`` for
    bfloat16 and float16 operands at ``bm``, ``bn`` in {64, 128} and
    ``bk % 16 == 0``, else ``"simt"``. The same rule as ``path_of`` in
    ``csrc/systolic_gemm.cu``, which refuses a launch told another path."""
    if dtype in (torch.bfloat16, torch.float16) and bm in (64, 128) \
            and bn in (64, 128) and bk % 16 == 0:
        return "wgmma"
    return "simt"


spill_path = kernel_path   # the name the WS/IS tests know the rule by


def check_tile(dataflow: str, bm: int, bk: int, bn: int) -> None:
    """Raise ``ValueError`` for a tile the kernels cannot take."""
    tile = f"(bm={bm}, bk={bk}, bn={bn})"
    if not all(isinstance(x, int) and x >= 1 for x in (bm, bk, bn)):
        raise ValueError(f"systolic_gemm: tile {tile} must be positive ints")
    if bm % SIDE or bn % SIDE or bm > MAX_SIDE or bn > MAX_SIDE:
        raise ValueError(f"systolic_gemm: tile {tile}: bm and bn must be "
                         f"multiples of {SIDE} up to {MAX_SIDE}")
    need = smem_bytes(dataflow, bm, bk, bn)
    if need > SMEM_LIMIT:
        raise ValueError(f"systolic_gemm: tile {tile} under {dataflow} "
                         f"needs {need} B of shared memory per block, above "
                         f"the {SMEM_LIMIT} B a block may use")


def _check_operands(a, b, out_dtype=None):
    if a.device != b.device:
        raise ValueError("systolic_gemm: a and b must share one device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError("systolic_gemm: a and b must be one of float32, "
                        f"bfloat16, float16, alike; got {a.dtype}, {b.dtype}")
    if out_dtype is not None and out_dtype not in DTYPES:
        raise TypeError("systolic_gemm: out_dtype must be float32, bfloat16 "
                        f"or float16, got {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or 0 in a.shape or b.shape[1] == 0:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def _check_blocks(a, b, dataflow, bm, bk, bn, k_mult=None, out_dtype=None):
    """Checks of a kernel-level call: operands, tile, tile multiples,
    contiguity, the device; returns ``(M, K, N)``."""
    _check_operands(a, b, out_dtype)
    check_tile(dataflow, bm, bk, bn)
    m, k = a.shape
    n = b.shape[1]
    if m % bm or k % (k_mult or bk) or n % bn:
        raise ValueError(f"systolic_gemm: shapes {(m, k, n)} are not "
                         f"multiples of the tile {(bm, k_mult or bk, bn)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("systolic_gemm: operands must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"systolic_gemm: unsupported device {a.device}")
    return m, k, n


def _launch(fn, a, b, out, head, tail) -> None:
    """Launch the kernel of site ``fn`` on the path :func:`kernel_path`
    names, on the current stream, and count it. The kernels read 16-B
    aligned operands (vector and TMA loads): a base that is not is
    copied."""
    bm, bk, bn = head[-3:]
    path = kernel_path(a.dtype, bm, bk, bn)
    a, b = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))
    lib = build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{fn.__name__}_launch")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), *head,
            DTYPES[a.dtype], *tail, PATHS.index(path), stream)
    if err != 0:
        raise RuntimeError(f"systolic_gemm: {fn.__name__} kernel launch "
                           f"failed: CUDA error {err}")
    fn.launches += 1
    fn.path_launches[path] += 1


def os_gemm(a, b, *, bm, bk, bn, out_dtype):
    """Output-stationary GEMM: ``(M, N)`` in ``out_dtype``."""
    m, k, n = _check_blocks(a, b, "OS", bm, bk, bn, out_dtype=out_dtype)
    if a.device.type == "cpu":
        return os_gemm_plain(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _launch(os_gemm, a, b, out, (m, k, n, bm, bk, bn), (DTYPES[out_dtype],))
    return out


def os_gemm_splitk(a, b, *, splits, bm, bk, bn):
    """Output-stationary split-K: ``(splits, M, N)`` float32 slabs; the
    caller sums them."""
    if not isinstance(splits, int) or splits < 1:
        raise ValueError(f"systolic_gemm: splits must be >= 1, got {splits}")
    m, k, n = _check_blocks(a, b, "OS", bm, bk, bn, k_mult=splits * bk)
    if a.device.type == "cpu":
        return os_gemm_splitk_plain(a, b, splits=splits, bm=bm, bk=bk, bn=bn)
    slabs = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    _launch(os_gemm_splitk, a, b, slabs, (m, k, n, splits, bm, bk, bn), ())
    return slabs


def _spill(fn, plain, dataflow, a, b, bm, bk, bn):
    m, k, n = _check_blocks(a, b, dataflow, bm, bk, bn)
    if a.device.type == "cpu":
        return plain(a, b, bm=bm, bk=bk, bn=bn)
    slabs = torch.empty((k // bk, m, n), dtype=torch.float32,
                        device=a.device)
    _launch(fn, a, b, slabs, (m, k, n, bm, bk, bn), ())
    return slabs


def ws_gemm_partials(a, b, *, bm, bk, bn):
    """Weight-stationary: ``(K/bk, M, N)`` float32 partials."""
    return _spill(ws_gemm_partials, ws_gemm_partials_plain, "WS", a, b,
                  bm, bk, bn)


def is_gemm_partials(a, b, *, bm, bk, bn):
    """Input-stationary: ``(K/bk, M, N)`` float32 partials."""
    return _spill(is_gemm_partials, is_gemm_partials_plain, "IS", a, b,
                  bm, bk, bn)


# the four kernel sites, each with its launch count
KERNELS = (os_gemm, os_gemm_splitk, ws_gemm_partials, is_gemm_partials)
reset_launch_count()


def _pad_to(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def systolic_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                  bk: int = 128, bn: int = 128, dataflow: str = "OS",
                  split_k: int = 1, out_dtype=None) -> torch.Tensor:
    """``a @ b`` through the paper's (dataflow, split-K, tile) mapping.

    Args:
      a: (M, K) left operand; b: (K, N) right operand, of one dtype
        (float32, bfloat16 or float16) and on one device.
      bm/bk/bn: the tile, the paper's (t_M, t_K, t_N).
      dataflow: OS | WS | IS (Sec IV-A).
      split_k: number of K shards for OS; each produces a float32 slab,
        summed here (the destination-chiplet reduction). WS/IS spill one
        slab per k-block by their nature and ignore it.
      out_dtype: output dtype (``a.dtype`` when None).
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"dataflow must be one of {DATAFLOWS}")
    out_dtype = out_dtype or a.dtype
    _check_operands(a, b, out_dtype)
    check_tile(dataflow, bm, bk, bn)
    m, n = a.shape[0], b.shape[1]

    ap = _pad_to(a, bm, bk)
    bp = _pad_to(b, bk, bn)
    if dataflow == "OS" and split_k > 1:
        # pad K so it also divides split_k * bk
        pk = (-ap.shape[1]) % (split_k * bk)
        if pk:
            ap = F.pad(ap, (0, pk))
            bp = F.pad(bp, (0, 0, 0, pk))

    if dataflow == "OS":
        if split_k > 1:
            slabs = os_gemm_splitk(ap, bp, splits=split_k, bm=bm, bk=bk,
                                   bn=bn)
            out = slabs.sum(dim=0).to(out_dtype)
        else:
            out = os_gemm(ap, bp, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    elif dataflow == "WS":
        slabs = ws_gemm_partials(ap, bp, bm=bm, bk=bk, bn=bn)
        out = slabs.sum(dim=0).to(out_dtype)
    else:  # IS
        slabs = is_gemm_partials(ap, bp, bm=bm, bk=bk, bn=bn)
        out = slabs.sum(dim=0).to(out_dtype)
    return out[:m, :n]
