"""Plain torch versions of the systolic GEMM and of its four kernels.

Each upcasts to float32 first (a bfloat16 or float16 product is exact
in float32) and takes one float32 product, so on the card they must run
with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``). The
kernel-level functions emit what the kernels emit: the output of
:func:`os_gemm_plain`, and the float32 slabs of the others, on operands
whose shapes are multiples of the tile (``bm``, ``bn`` and, for the
slabs, ``bk`` shape the result; the tile of :func:`os_gemm_plain` does
not)."""
from __future__ import annotations

import torch


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """``a @ b`` with float32 products and sums, cast to ``out_dtype``
    (``a.dtype`` when None): the oracle of every mapping of
    :func:`~repro_torch.kernels.systolic_gemm.ops.systolic_gemm`."""
    out = a.float() @ b.float()
    return out.to(out_dtype or a.dtype)


def os_gemm_plain(a, b, *, bm, bk, bn, out_dtype):
    """Output-stationary: the ``(M, N)`` product in ``out_dtype``."""
    return gemm_plain(a, b, out_dtype)


def _k_blocks(a, b, n_blocks):
    """``a`` as ``(n_blocks, M, K/n_blocks)`` and ``b`` as ``(n_blocks,
    K/n_blocks, N)``, float32."""
    m, k = a.shape
    a3 = a.float().reshape(m, n_blocks, k // n_blocks).transpose(0, 1)
    return a3, b.float().reshape(n_blocks, k // n_blocks, b.shape[1])


def os_gemm_splitk_plain(a, b, *, splits, bm, bk, bn):
    """Output-stationary split-K: ``(splits, M, N)`` float32 slabs, slab
    ``s`` the product over K shard ``s``."""
    return torch.bmm(*_k_blocks(a, b, splits))


def ws_gemm_partials_plain(a, b, *, bm, bk, bn):
    """Weight-stationary: ``(K/bk, M, N)`` float32 partials, one per
    k-block."""
    return torch.bmm(*_k_blocks(a, b, a.shape[1] // bk))


def is_gemm_partials_plain(a, b, *, bm, bk, bn):
    """Input-stationary: the same ``(K/bk, M, N)`` partials as
    :func:`ws_gemm_partials_plain` (the dataflows differ in loop order
    and residency, not in what they emit)."""
    return ws_gemm_partials_plain(a, b, bm=bm, bk=bk, bn=bn)
