"""Carry state saved by the JAX reference package into this package.

The reference's state leaves it as plain data: ``dataclasses.asdict`` of
its ``TechDB`` (possibly through JSON, which turns int keys into strings
and tuples into lists), a fitted normalizer's ``(mins, medians)``
arrays, a Pareto archive's ``checkpoint_arrays()`` dict, a language
model's parameter and decode-cache pytrees (nested dicts of arrays with
the layers stacked on a leading axis) and its AdamW state. Encoded
populations are int32 arrays and pass unchanged. A model's parameters
also go back to the reference's tree (:func:`lm_params_to_reference`),
the layout ``launch/train.py`` checkpoints in. Nothing here imports the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, hybrid_layout, require_ported
from repro_torch.core.techdb import MemorySpec, PackageSpec, ProtocolSpec, TechDB
from repro_torch.core.templates import METRIC_FIELDS, Normalizer
from repro_torch.optim.adamw import AdamWState
from repro_torch.pathfinding.pareto import ParetoArchive

_SPECS = {"memories": MemorySpec, "packages": PackageSpec,
          "protocols": ProtocolSpec}


def _tuple(x):
    return tuple(_tuple(i) for i in x) if isinstance(x, (list, tuple)) else x


def _key(k):
    return int(k) if isinstance(k, str) and k.lstrip("-").isdigit() else k


def techdb_from_fields(fields: Mapping[str, Any]) -> TechDB:
    """A :class:`TechDB` from the reference ``TechDB``'s field dict.

    Nested package/protocol/memory specs may arrive as dicts; int-keyed
    tables (per node, per array size) may arrive with string keys; and
    sequences as lists. Unknown field names raise."""
    names = {f.name for f in dataclasses.fields(TechDB)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"TechDB has no fields {sorted(unknown)}")
    kw: Dict[str, Any] = {}
    for name, value in fields.items():
        if name in _SPECS:
            spec = _SPECS[name]
            value = {k: v if isinstance(v, spec) else spec(**v)
                     for k, v in value.items()}
        elif isinstance(value, Mapping):
            value = {_key(k): _tuple(v) for k, v in value.items()}
        elif isinstance(value, (list, tuple)):
            value = _tuple(value)
        kw[name] = value
    return TechDB(**kw)


def normalizer_from_arrays(mins, medians) -> Normalizer:
    """A :class:`Normalizer` from the reference's
    ``Normalizer.weights_arrays()`` (METRIC_FIELDS order)."""
    mins = np.asarray(mins, dtype=np.float64)
    medians = np.asarray(medians, dtype=np.float64)
    if mins.shape != (len(METRIC_FIELDS),) or medians.shape != mins.shape:
        raise ValueError(f"expected two [{len(METRIC_FIELDS)}] arrays, got "
                         f"{mins.shape} and {medians.shape}")
    return Normalizer({f: float(v) for f, v in zip(METRIC_FIELDS, mins)},
                      {f: float(v) for f, v in zip(METRIC_FIELDS, medians)})


def archive_from_arrays(arrays: Mapping[str, np.ndarray],
                        max_size: int = 256) -> ParetoArchive:
    """A :class:`ParetoArchive` holding the reference archive's
    ``checkpoint_arrays()`` contents (``enc`` int32 rows, ``vec``
    float64 objective vectors)."""
    return ParetoArchive(max_size=max_size).from_checkpoint_arrays(
        {"enc": arrays["enc"], "vec": arrays["vec"]})


def _tensor(arr: np.ndarray, copy: bool) -> torch.Tensor:
    """``arr`` as a tensor: a copy, or a view of its memory when ``copy``
    is false and ``arr`` is writable."""
    if copy or not arr.flags.writeable:
        return torch.tensor(arr)
    return torch.from_numpy(arr)


def _layer_slices(tree: Mapping[str, Any], n_layers: int, prefix: str,
                  out: Dict[str, torch.Tensor], copy: bool = True) -> None:
    """Split each leaf of a layer-stacked subtree into ``n_layers``
    entries ``{prefix}{l}.{path}`` (views of it unless ``copy``)."""
    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
            return
        arr = np.asarray(node)
        if arr.ndim < 1 or arr.shape[0] != n_layers:
            raise ValueError(f"{path}: expected a leading axis of "
                             f"{n_layers} layers, got shape {arr.shape}")
        for i in range(n_layers):
            out[f"{prefix}{i}.{path}"] = _tensor(arr[i], copy)
    walk(tree, "")


def lm_params_from_reference(tree: Mapping[str, Any], cfg: ModelConfig,
                             copy: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`repro_torch.models.transformer.LM`
    from the reference's ``init_model`` pytree as numpy arrays, unstacked
    per layer: ``layers`` (dense and ssm, stacked on L); ``groups`` of
    ``{dense, moe}`` (Llama-4) or ``dense_layers`` and ``moe_layers``
    (DeepSeek-V2), the experts stacked (L, E, D, F); or ``groups`` and
    ``tail`` (hybrid, stacked on the group and tail counts); vlm and
    audio have the dense ``layers``. Load it with
    ``model.load_state_dict(...)``, which rejects missing or extra
    names (a tied model has no ``lm_head``). With ``copy=False`` each
    tensor is a view of its (writable) array, for a caller that copies
    it at once."""
    require_ported(cfg)
    out = {k: _tensor(np.asarray(tree[k]), copy)
           for k in ("embed", "final_norm", "lm_head") if k in tree}
    if cfg.family in ("dense", "vlm", "audio", "ssm"):
        _layer_slices(tree["layers"], cfg.n_layers, "layers.", out, copy)
        return out
    if cfg.family == "moe":
        n_moe, n_dense = cfg.moe_layout()
        if cfg.moe_every > 1:
            _layer_slices(tree["groups"], n_moe, "groups.", out, copy)
            return out
        for key, n in (("dense_layers", n_dense), ("moe_layers", n_moe)):
            if n:
                _layer_slices(tree[key], n, f"{key}.", out, copy)
        return out
    n_groups, tail = hybrid_layout(cfg)
    _layer_slices(tree["groups"], n_groups, "groups.", out, copy)
    if tail:
        _layer_slices(tree["tail"], tail, "tail.", out, copy)
    return out


def _reference_tree(params: Mapping[str, torch.Tensor], leaf, stacked
                    ) -> Dict[str, Any]:
    """The reference's tree over ``params`` (named as ``LM``'s
    ``named_parameters()``): each per-layer list's entries ``{list}.{l}.
    {path}`` go, in layer order, to ``stacked`` as ``{list}/{path}``, the
    other tensors to ``leaf``."""
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in params.items():
        first, *rest = name.split(".")
        if rest and rest[0].isdigit():
            stacks.setdefault((first, *rest[1:]), {})[int(rest[0])] = t
        else:
            tree[name] = leaf(t)
    for (first, *path), rows in stacks.items():
        node = tree.setdefault(first, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = stacked([rows[i] for i in range(len(rows))])
    return tree


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """numpy's dtype for ``t`` on the host: float32 for bfloat16."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` copied once, straight from its device, into a new numpy
    array."""
    out = np.empty(tuple(t.shape), dtype=_host_dtype(t))
    torch.from_numpy(out).copy_(t.detach())
    return out


def _stack_to_host(rows) -> np.ndarray:
    """``rows`` (tensors of one shape) stacked into a new numpy array,
    each copied once, straight from its device into its slice."""
    shape = tuple(rows[0].shape)
    out = np.empty((len(rows),) + shape, dtype=_host_dtype(rows[0]))
    dst = torch.from_numpy(out)
    for i, t in enumerate(rows):
        if tuple(t.shape) != shape:
            raise ValueError(f"layer {i} has shape {tuple(t.shape)}, "
                             f"layer 0 {shape}")
        dst[i].copy_(t.detach())
    return out


def lm_params_to_reference(params: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Any]:
    """The reference's parameter tree, as numpy arrays, from a dict named
    as :class:`repro_torch.models.transformer.LM`'s ``named_parameters()``
    (or ``state_dict()``): each per-layer list's entries ``{list}.{l}.
    {path}`` stacked on a leading axis into ``{list}/{path}``, the other
    leaves as they are. The inverse of :func:`lm_params_from_reference`.
    Every array is new (none shares memory with a tensor), each tensor
    copied once into it. bfloat16 leaves come out as float32 (exactly;
    numpy has no bfloat16), and a copy back into the model rounds them
    to what they were."""
    return _reference_tree(params, _to_host, _stack_to_host)


def lm_reference_shapes(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The tree of :func:`lm_params_to_reference` with each array's shape
    and no data: a leaf is a tensor on the ``meta`` device. A template for
    ``CheckpointManager.restore``, which reads only the shapes."""
    def shape(rows):
        return torch.empty((len(rows),) + tuple(rows[0].shape),
                           device="meta")

    return _reference_tree(params, lambda t: torch.empty(t.shape,
                                                         device="meta"),
                           shape)


def adamw_state_from_reference(step, mu: Mapping[str, Any],
                               nu: Mapping[str, Any], cfg: ModelConfig,
                               device=None):
    """The port's :class:`repro_torch.optim.AdamWState` from the
    reference's ``AdamWState`` fields as numpy (``step`` a 0-d int32,
    ``mu`` and ``nu`` parameter-shaped trees), its moments named as the
    model's parameters, on ``device``."""
    def moments(tree):              # one copy of each, onto ``device``
        return {k: v.to(device, copy=True) for k, v in
                lm_params_from_reference(tree, cfg, copy=False).items()}

    return AdamWState(
        torch.as_tensor(np.asarray(step, dtype=np.int32), device=device),
        moments(mu), moments(nu))


def cache_from_reference(cache: Mapping[str, Any], cfg: ModelConfig):
    """The port's decode cache from the reference's stacked one, as numpy
    arrays:

    - dense and vlm: ``{"kv": (k, v)}``, each (L,B,T,KV,Dh), becomes ``{"kv":
      [(k, v), ...]}``, one pair per layer;
    - ssm: ``{"wkv": (L,B,H,Dh,Dh), "tm_x": (L,B,D), "cm_x": (L,B,D)}``
      becomes one dict per layer;
    - moe: ``{"kv_dense", "kv_moe": (k, v) each (G,B,T,KV,Dh)}``
      (Llama-4) and ``{"latent_dense", "latent": (c_kv (n,B,T,r_kv),
      k_rope (n,B,T,dr))}`` (DeepSeek-V2) become one list of pairs per
      key;
    - hybrid: ``{"rg1", "rg2", "tail": {"conv": (n,B,K-1,W), "h":
      (n,B,W)}, "kv": (k, v) each (G,B,win,KV,Dh)}`` becomes
      ``{"groups": [{"rg1", "rg2", "kv"}, ...], "tail": [...]}``.
    """
    require_ported(cfg)
    flat: Dict[str, torch.Tensor] = {}
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.family != "moe":
            layers = {"kv": cfg.n_layers}
        else:
            n_moe, n_dense = cfg.moe_layout()
            layers = ({"kv_dense": n_moe, "kv_moe": n_moe}
                      if cfg.moe_every > 1 else
                      {"latent_dense": n_dense, "latent": n_moe})
        unknown = set(cache) - set(layers)
        if unknown:
            raise ValueError(f"{cfg.name}'s cache has no {sorted(unknown)}")
        out = {}
        for key, pair in cache.items():
            a, b = pair
            n = layers[key]
            _layer_slices({"a": a, "b": b}, n, f"{key}.", flat)
            out[key] = [(flat[f"{key}.{i}.a"], flat[f"{key}.{i}.b"])
                        for i in range(n)]
        return out
    if cfg.family == "ssm":
        names = ("tm_x", "wkv", "cm_x")
        _layer_slices({k: cache[k] for k in names}, cfg.n_layers, "", flat)
        return [{k: flat[f"{i}.{k}"] for k in names}
                for i in range(cfg.n_layers)]
    n_groups, tail = hybrid_layout(cfg)
    k, v = cache["kv"]
    _layer_slices({"rg1": cache["rg1"], "rg2": cache["rg2"],
                   "k": k, "v": v}, n_groups, "", flat)
    if tail:
        _layer_slices(cache["tail"], tail, "tail.", flat)

    def state(pre):
        return {"conv": flat[f"{pre}.conv"], "h": flat[f"{pre}.h"]}

    return {"groups": [{"rg1": state(f"{i}.rg1"), "rg2": state(f"{i}.rg2"),
                        "kv": (flat[f"{i}.k"], flat[f"{i}.v"])}
                       for i in range(n_groups)],
            "tail": [state(f"tail.{j}") for j in range(tail)]}
