"""Work counted over a step: FLOPs, bytes, collectives and live memory.

The counterpart of the JAX package's ``analysis/hlo.py``, which parses
collectives out of compiled HLO text while XLA's ``cost_analysis()``
gives FLOPs and bytes. On the card there is no HLO to parse, so one
``TorchDispatchMode``, :class:`OpCounter`, watches every aten op a step
runs and counts:

- **FLOPs**: the matrix-family formulas of ``torch.utils.flop_counter``
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention);
  element-wise ops count none, as there.
- **Bytes**: per aten op, the bytes of its tensor inputs plus those of
  its outputs. An op whose output aliases an input without writing it
  (views, reshapes, ``detach``, ``_unsafe_view``) and an allocation
  (``empty*``) count 0. An op that writes into an argument counts its
  other inputs plus what it writes there: an indexed write
  (``index_put_``, ``index_copy_``, ``index_fill_``, ``scatter*``,
  ``index_add_``) the elements it writes (read too where it adds into
  them), an overwrite (``copy_``, ``fill_``, ``zero_``, ``out=``) the
  destination once, any other in-place op (``add_``, ``mul_``) the
  destination read and written. This is the unfused eager traffic:
  every op reads its operands from device memory and writes its result
  back, as the port's eager steps do. A fused program would move less.
- **Collectives**: the ``_c10d_functional`` ops, by kind, in the JAX
  package's dict format (:func:`collective_bytes`): bytes of each
  result (the result-shape convention), ``<kind>_count`` and
  ``total``. ``wait_tensor`` completes an op already counted and counts
  nothing, as an HLO ``-done`` op does not.
- **Live memory**: the bytes of the storages the step allocates, while
  they live; ``peak_bytes`` is their peak (the dry-run's
  ``temp_size_in_bytes``). Storages that existed before the step
  (weights, optimizer state, inputs) are not counted.

An op is counted when one of its tensors lies on the counter's device
(``device``): a cuda step's host-side ops (``torch.utils.checkpoint``
cloning the CPU copy of the RNG state) are not device work.

**Hand-written kernels are counted once, by formula.** The port's CUDA
kernels are ``ctypes`` calls (``kernels/_build.py``) that the dispatcher
never sees, so their wrappers report their work through
``kernels/_build.py::counted``: the operations and bytes of the
kernel's own least-work formula (``kernels/wkv6/ops.py::work``,
``kernels/rglru/ops.py::work``), with the aten ops inside the wrapper
hidden. A counter adds itself to the wrappers' hook list
(``_build.COUNTERS``) while it is entered. The count is then the same
whatever computes the function: the kernel on cuda, the plain version
on the CPU, or empty outputs on ``meta``. A backward counts what it
runs: ``rglru``'s reverse launch by formula plus the aten ops around
it, ``wkv6``'s plain recompute by its aten ops.
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ``_c10d_functional`` ops by collective kind. Torch has no functional
# collective-permute: ``permute_tensor`` runs as ``all_to_all_single``.
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_aten = torch.ops.aten
# outputs that move no data: a view without an alias annotation, and
# allocations
_NO_TRAFFIC = {_aten._unsafe_view.default, _aten.empty.memory_format,
               _aten.empty_strided.default, _aten.empty_like.default,
               _aten.new_empty.default, _aten.new_empty_strided.default}
# in-place ops that overwrite their destination without reading it
_OVERWRITE = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
              _aten.zero_.default}


def _index_numel(self: torch.Tensor, indices) -> int:
    """Elements of ``self[indices]`` for ``index_put_``'s index list: the
    broadcast shape of the index tensors times the dimensions no index
    consumes. A boolean mask consumes its dimensions and counts all their
    elements (its true entries are data; the count is the most the write
    can touch)."""
    shapes, n, d = [], 1, 0
    for i in indices:
        if i is None:
            n *= self.shape[d]
            d += 1
        elif i.dtype in (torch.bool, torch.uint8):
            shapes.append((i.numel(),))
            d += i.dim()
        else:
            shapes.append(tuple(i.shape))
            d += 1
    for size in tuple(torch.broadcast_shapes(*shapes)) + self.shape[d:]:
        n *= size
    return n


def _slices(self, dim, index) -> int:
    return self.numel() // max(self.shape[dim], 1) * index.numel() \
        if self.dim() else index.numel()


# indexed writes: op -> (elements written, whether it adds into them),
# from the op's arguments
_PARTIAL = {
    _aten.index_put_.default:
        lambda s, ind, v, acc=False: (_index_numel(s, ind), bool(acc)),
    _aten._index_put_impl_.default:
        lambda s, ind, v, acc=False, *_: (_index_numel(s, ind), bool(acc)),
    _aten.index_copy_.default:
        lambda s, dim, idx, src: (src.numel(), False),
    _aten.index_add_.default:
        lambda s, dim, idx, src, *_, **__: (src.numel(), True),
    _aten.index_fill_.int_Scalar:
        lambda s, dim, idx, v: (_slices(s, dim, idx), False),
    _aten.index_fill_.int_Tensor:
        lambda s, dim, idx, v: (_slices(s, dim, idx), False),
    _aten.scatter_.src: lambda s, dim, idx, src: (idx.numel(), False),
    _aten.scatter_.value: lambda s, dim, idx, v: (idx.numel(), False),
    _aten.scatter_.reduce:
        lambda s, dim, idx, src, **_: (idx.numel(), True),
    _aten.scatter_.value_reduce:
        lambda s, dim, idx, v, **_: (idx.numel(), True),
    _aten.scatter_add_.default:
        lambda s, dim, idx, src: (idx.numel(), True),
    _aten.scatter_reduce_.two:
        lambda s, dim, idx, src, *_, **__: (idx.numel(), True),
}


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Bytes moved per collective kind (result-shape convention), plus op
    counts as ``<kind>_count`` and the ``total`` over kinds, from
    ``(kind, result bytes)`` records: the JAX package's
    ``collective_bytes`` format."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, nbytes in records:
        out[kind] += nbytes
        counts[kind] += 1
    result: Dict[str, float] = {}
    for k in COLLECTIVE_KINDS:
        if counts[k]:
            result[k] = out[k]
            result[k + "_count"] = counts[k]
    result["total"] = sum(out.values())
    return result


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd decomposition."""
    return func.has_kernel_for_dispatch_key(
        torch._C.DispatchKey.CompositeImplicitAutograd)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _traffic(func, args, kwargs, out) -> int:
    """Bytes one aten op moves, by the rules of the module docstring."""
    if func in _NO_TRAFFIC:
        return 0
    schema = func._schema
    read: List[torch.Tensor] = []
    dest: List[torch.Tensor] = []
    out_arg = False
    for i, a in enumerate(schema.arguments):
        ts = _tensors(args[i] if i < len(args) else kwargs.get(a.name))
        if a.alias_info is not None and a.alias_info.is_write:
            dest += ts
            out_arg |= a.is_out
        else:
            read += ts
    outs = [out] if len(schema.returns) == 1 else list(out or ())
    fresh = [t for r, o in zip(schema.returns, outs) if r.alias_info is None
             for t in _tensors(o)]
    nbytes = sum(_nbytes(t) for t in read + fresh)
    if not dest:
        # a view: every result aliases an input, nothing is written
        return 0 if any(r.alias_info is not None for r in schema.returns) \
            else nbytes
    partial = _PARTIAL.get(func)
    if partial is not None:
        n, adds = partial(*args, **kwargs)
        return nbytes + n * dest[0].element_size() * (2 if adds else 1)
    written = sum(_nbytes(t) for t in dest)
    once = out_arg or func in _OVERWRITE
    return nbytes + written * (1 if once else 2)


class OpCounter(TorchDispatchMode):
    """Counts the work of the aten ops run under it on ``device`` (a
    device or a type: "cuda", "cpu", "meta"), and the work hand-written
    kernels report (``kernels/_build.py::counted``). Use as a context manager around one
    step::

        with OpCounter("meta") as c:
            fn(*args)
        c.flops, c.bytes, c.collectives, c.peak_bytes
    """

    def __init__(self, device="cpu"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])
        self.kernels: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])
        self._coll: List[Tuple[str, int]] = []
        self._hidden = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._entered = 0

    @property
    def collectives(self) -> Dict[str, float]:
        return collective_bytes(self._coll)

    def summary(self) -> Dict[str, object]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives,
                "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(calls=v[0], ops=v[1], bytes=v[2])
                            for k, v in self.kernels.items()}}

    def __enter__(self):
        # re-entered while it decomposes an op: listed once
        if not self._entered:
            _build.COUNTERS.append(self)
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if not self._entered:
            _build.COUNTERS.remove(self)
        return super().__exit__(*exc)

    # -- hand-written kernels (``kernels/_build.py::counted``) ------------

    def enter_kernel(self, name: str, ops: int, nbytes: int) -> None:
        if not self._hidden:
            self.flops += ops
            self.bytes += nbytes
            k = self.kernels[name]
            k[0] += 1
            k[1] += ops
            k[2] += nbytes
        self._hidden += 1

    def exit_kernel(self) -> None:
        self._hidden -= 1

    # -- live storages -----------------------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, outs: List[torch.Tensor], ins: List[torch.Tensor]):
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- aten ops ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":     # metadata (``.device``): no work
            return func(*args, **kwargs)
        if any(t.__name__ == "DTensor" for t in types):
            # a DTensor op runs as its local ops and collectives, each of
            # which comes back here on this rank's shapes
            return NotImplemented
        if _composite(func):
            # an op that reaches this mode whole (under inference_mode,
            # ``matmul``) runs as the ops it is made of, as it does under
            # autograd, so each is counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        ns, _, name = func._schema.name.partition("::")
        if ns == "_c10d_functional":
            if name in _COLLECTIVES and not self._hidden:
                self._coll.append((_COLLECTIVES[name],
                                   sum(_nbytes(t) for t in outs)))
            return out
        returns = func._schema.returns
        aliased = any(r.alias_info is not None for r in returns)
        if not aliased:
            self._track(outs, ins)
        if self._hidden:
            return out
        nbytes = _traffic(func, args, kwargs, out)
        formula = flop_registry.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        self.flops += flops
        self.bytes += nbytes
        rec = self.by_op[str(func._overloadpacket)]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out


__all__ = ["COLLECTIVE_KINDS", "OpCounter", "collective_bytes"]
