"""The yardstick's work counts: the H100's peaks, the least bytes of a
``prefix_select`` launch, the least bytes of a sweep, and the float64
operations of a sweep as a dispatch counter counts them.

The peaks are NVIDIA's data-sheet figures for the H100 SXM part at its
700 W limit. The float64 rate is the non-tensor-core vector rate, which
is the one the search's elementwise float64 arithmetic can use.
"""
from __future__ import annotations

from typing import Dict, Optional

H100 = dict(
    hbm_bytes_per_s=3.35e12,
    fp64_flops=34e12,
    fp32_flops=67e12,
)


def prefix_select_bound(args) -> Dict[str, float]:
    """Least time of one ``prefix_select`` launch on these inputs: the
    distinct table entries they touch, the indices read once and the
    outputs written once, over HBM bandwidth; against one subtract and one
    add per output at the float32 vector rate (int64 adds are rated as
    float32 ones, which does not matter: bytes bound). The inputs are the
    kernel's ``(pref0, pref1, rows, start, end, split, t0, t1)``; a copy
    of ``kernel_bound`` from the program's ``chip_smoke.py``."""
    import torch

    p0, p1, rows, start, end, split, t0, t1 = args
    F, R = p0.shape[:2]
    P, C = rows.shape
    if max(p0.shape[2], p1.shape[2]) > 4096:
        raise ValueError("tile axis longer than the id packing allows")
    sp = (split == 1)[:, None]
    t = torch.where(sp, t1[:, None], t0[:, None]).long()
    s = torch.minimum(start.long().clamp(min=0), t)
    e = torch.minimum(end.long().clamp(min=0), t)
    which = sp.long().expand(P, C)
    ids = [((which * R + rows.long()) * 4096 + idx).reshape(-1)
           for idx in (s, e)]
    n_entries = int(torch.unique(torch.cat(ids)).numel()) * F
    nbytes = (n_entries * 8 + (3 * P * C + 3 * P) * 4
              + (P * C * F + P * F) * 8)
    ops = 2 * P * C * F
    t_bytes = nbytes / H100["hbm_bytes_per_s"]
    t_ops = ops / H100["fp32_flops"]
    return dict(bound_s=max(t_bytes, t_ops), bytes=nbytes, ops=ops,
                entry_bytes=n_entries * 8,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sweep_bound_s(work: dict, rows: int, width: int,
                  gather_bytes: float) -> Optional[float]:
    """Least time of one sweep of ``rows`` designs of ``width`` int32
    columns, from the cell's frozen work file: the larger of its bytes
    (rows read and written as int32, float64 outputs written, the prefix
    entries gathered) over HBM bandwidth and its counted float64
    operations over the float64 rate."""
    if not work:
        return None
    b = work["bytes_per_row"]
    nbytes = rows * (4 * width * (b["rows_read"] + b["rows_written"])
                     + 8 * b["f64_written"]) + gather_bytes
    ops = work["f64_ops_per_row"] * rows + work["f64_ops_fixed"]
    return max(nbytes / H100["hbm_bytes_per_s"], ops / H100["fp64_flops"])


class F64Counter:
    """Counts the float64 operations of the aten ops run inside it: an op
    with a float64 result counts one operation per result element, a
    reduction one per input element. Views, copies, fills and index
    moves count none."""

    ARITH = frozenset((
        "exp", "exp2", "log", "log1p", "log2", "sqrt", "rsqrt", "pow",
        "mul", "div", "add", "sub", "rsub", "reciprocal", "tanh",
        "sigmoid", "minimum", "maximum", "clamp", "clamp_min", "clamp_max",
        "abs", "neg", "floor", "ceil", "trunc", "round", "fmod",
        "remainder", "square"))
    REDUCE = frozenset((
        "sum", "prod", "mean", "cumsum", "cumprod", "amax", "amin", "max",
        "min", "logsumexp"))

    def __init__(self):
        self.ops = 0

    def count(self, name: str, args, out) -> None:
        import torch

        outs = out if isinstance(out, (tuple, list)) else (out,)
        f64 = [o for o in outs if isinstance(o, torch.Tensor)
               and o.dtype == torch.float64]
        if not f64:
            return
        op = name.split("::")[-1].split(".")[0].rstrip("_")
        if op in self.REDUCE:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.ops += int(ins[0].numel()) if ins else 0
        elif op in self.ARITH:
            self.ops += sum(int(o.numel()) for o in f64)

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.count(str(func.name()), args, out)
                return out

        return _Mode()


def linear_fit(p1: int, c1: int, p2: int, c2: int) -> Dict[str, float]:
    """``count = per_row * rows + fixed`` through two counts."""
    per_row = (c2 - c1) / (p2 - p1)
    return dict(per_row=per_row, fixed=c1 - per_row * p1)
