"""Sharding rules: parameter, optimizer, batch, activation and cache
placement, and the scenario axis over ranks. The torch counterpart of
the JAX package's ``distributed/sharding.py``.

Strategy (DP x TP/EP with FSDP-style weight sharding), as the JAX
package's:

  * batch dims           -> ('pod', 'data')        (pure DP; 'pod' = DCN)
  * heads / d_ff / vocab / experts -> 'model'      (TP / EP)
  * the remaining large weight dim -> 'data'       (FSDP; ZeRO-1 falls out
    because the AdamW moments mirror the parameters' specs)
  * decode caches: sequence axis -> 'model'
  * residual stream between layers -> seq over 'model' (Megatron-style
    SP, while an :func:`activation_policy` is live).

A spec is the port's ``PartitionSpec``: a tuple with one entry per
tensor dimension, each ``None``, a mesh axis name, or a tuple of names.
Every rule is divisibility-aware: an axis that does not divide a
dimension is dropped (replicated), so internvl2's vocab 92553 stays
whole while its d_model shards. The rules are pure functions of shapes
and axis sizes; a mesh is anything with ``axis_names`` and a
``shape`` mapping (the JAX package's ``Mesh``, a test's stand-in) or a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``.

Parameters are named as :class:`repro_torch.models.transformer.LM`'s
``named_parameters()``. The rules match the JAX package's leaf names,
where a per-layer list is stacked on a leading layer axis
(``layers.3.attn.wq`` is a row of ``layers/attn/wq``); the spec of a
per-layer tensor is the stacked leaf's spec without its leading entry,
which no rule shards. Caches are named the same way.

:func:`placements` turns a spec into DTensor placements, one per mesh
dimension, and :func:`distribute` places a dict of tensors (or a
model's parameters, :func:`distribute_model`) on a ``DeviceMesh``. Each
rank slices its shard from its own full tensor (every rank draws the
same weights from the same seed), so placing moves no data.

The scenario axis (:func:`scenario_mesh`, :func:`shard_scenarios`,
:func:`gather_scenarios`) splits a grid's cells over the ranks of a
live process group; without one, a mesh is the tuple of the run's one
device, and placing the arrays is putting each on it.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device

# Sentinel for "the DP axes of whatever mesh we're on"
DATA = "__data__"

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Meshes as axis sizes
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> Dict[str, int]:
    """The mesh's axis names and sizes, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch (pure-DP) axes: ('pod', 'data') on multi-pod meshes."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


# ---------------------------------------------------------------------------
# Divisibility-aware spec fitting
# ---------------------------------------------------------------------------


def _resolve_axis(entry, mesh, axes) -> Optional[Tuple[str, ...]]:
    if entry is None:
        return None
    if entry == DATA:
        return data_axes(mesh) or None
    if isinstance(entry, str):
        return (entry,) if entry in axes else None
    return tuple(a for a in entry if a in axes) or None


def fit_spec(shape: Sequence[int], spec: Sequence, mesh) -> Spec:
    """Resolve DATA, drop missing mesh axes and non-dividing entries.
    The result has one entry per dimension of ``shape``."""
    sizes = mesh_axes(mesh)
    out: List[Any] = []
    used = set()
    for dim, entry in zip(shape, spec):
        axes = _resolve_axis(entry, mesh, sizes)
        if axes is None:
            out.append(None)
            continue
        axes = tuple(a for a in axes if a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        elif len(axes) > 1:
            # try the largest single axis that divides
            picked = None
            for a in sorted(axes, key=lambda a: -sizes[a]):
                if dim % sizes[a] == 0:
                    picked = a
                    break
            out.append(picked)
            if picked:
                used.add(picked)
        else:
            out.append(None)
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def replicated(ndim: int) -> Spec:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# Parameter rules (matched on the reference leaf name's suffix)
# ---------------------------------------------------------------------------

# name -> spec by the stacked leaf's ndim (a leading L axis = None)
_PARAM_RULES = [
    # embeddings / heads: vocab over 'model' only (sharding D over 'data'
    # would conflict with batch-over-'data' in the loss)
    (r"embed$", {2: ("model", None)}),
    (r"lm_head$", {2: (None, "model")}),
    # attention
    (r"(wq|wk|wv)$", {3: (None, DATA, "model")}),
    (r"(bq|bk|bv)$", {2: (None, "model")}),
    (r"wo$", {3: (None, "model", DATA)}),
    # MLA
    (r"(w_dq|w_dkv)$", {3: (None, DATA, None)}),
    (r"(w_uq|w_uk|w_uv)$", {3: (None, None, "model")}),
    # FFN (dense 3d, MoE experts 4d: (L, E, D, F))
    (r"(w_gate|w_up)$", {3: (None, DATA, "model"),
                         4: (None, "model", DATA, None)}),
    (r"w_down$", {3: (None, "model", DATA),
                  4: (None, "model", None, DATA)}),
    (r"router$", {3: (None, DATA, None)}),
    # rwkv time/channel mix
    (r"(w_r|w_k|w_v|w_g)$", {3: (None, DATA, "model")}),
    (r"w_o$", {3: (None, "model", DATA)}),
    (r"(lora_a|decay_a)$", {3: (None, DATA, None)}),
    # rglru
    (r"(w_in)$", {3: (None, DATA, "model")}),
    (r"w_out$", {3: (None, "model", DATA)}),
    (r"conv_w$", {3: (None, None, "model")}),
    (r"(conv_b|gate_a_b|gate_x_b|lam)$", {2: (None, "model")}),
    (r"(gate_a|gate_x)$", {4: (None, "model", None, None)}),
]

# Serving layout overrides: decode batches are tiny, so expert weights
# keep D whole and shard the FFN dim over the dp axes
_SERVING_OVERRIDES = [
    (r"(w_gate|w_up)$", {4: (None, "model", None, DATA)}),
    (r"w_down$", {4: (None, "model", DATA, None)}),
]


def param_spec_for(name: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of the JAX package's leaf ``name`` (``/``-joined) of
    ``shape`` (stacked leaves with their layer axis)."""
    for pattern, by_ndim in _PARAM_RULES:
        if re.search(pattern, name):
            spec = by_ndim.get(len(shape))
            if spec is not None:
                return fit_spec(shape, spec, mesh)
    # default: shard the two largest dims over (data, model) if they divide
    if len(shape) >= 2 and shape[-1] * shape[-2] >= 1 << 20:
        return fit_spec(shape, (None,) * (len(shape) - 2) + (DATA, "model"),
                        mesh)
    return replicated(len(shape))


def reference_name(name: str) -> Tuple[str, bool]:
    """The JAX package's leaf name of the port's parameter ``name`` and
    whether that leaf stacks a per-layer list (``layers.3.attn.wq`` ->
    ``("layers/attn/wq", True)``)."""
    first, *rest = name.split(".")
    if rest and rest[0].isdigit():
        return "/".join([first] + rest[1:]), True
    return "/".join([first] + rest), False


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _stacked_specs(params, mesh, spec_for) -> Dict[str, Spec]:
    """``spec_for(reference name, reference shape, mesh)`` of every
    parameter, per-layer ones from their stacked leaf without its layer
    entry."""
    named = _named_tensors(params)
    depth: Dict[str, int] = {}
    for name in named:
        ref, stacked = reference_name(name)
        if stacked:
            depth[ref] = depth.get(ref, 0) + 1
    out = {}
    for name, t in named.items():
        ref, stacked = reference_name(name)
        if not stacked:
            out[name] = spec_for(ref, tuple(t.shape), mesh)
            continue
        spec = spec_for(ref, (depth[ref],) + tuple(t.shape), mesh)
        if spec[0] is not None:
            raise ValueError(f"{ref}: a rule shards the layer axis "
                             f"({spec}), which a per-layer tensor cannot "
                             "hold")
        out[name] = spec[1:]
    return out


def param_specs(params, mesh) -> Dict[str, Spec]:
    """{name: spec} of a model's parameters (an ``nn.Module`` or a dict
    named as its ``named_parameters()``)."""
    return _stacked_specs(params, mesh, param_spec_for)


def _serving_spec_for(name: str, shape, mesh) -> Spec:
    for pattern, by_ndim in _SERVING_OVERRIDES:
        if re.search(pattern, name) and len(shape) in by_ndim:
            return fit_spec(shape, by_ndim[len(shape)], mesh)
    return param_spec_for(name, shape, mesh)


def param_specs_serving(params, mesh) -> Dict[str, Spec]:
    """:func:`param_specs` with the serving layout of the experts."""
    return _stacked_specs(params, mesh, _serving_spec_for)


def opt_state_specs(opt_state, pspecs: Dict[str, Spec]):
    """The AdamW moments mirror the parameters' specs (ZeRO-1); the step
    is replicated."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=(), mu=dict(pspecs), nu=dict(pspecs))


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """tokens/labels (B, S) -> (DATA, None); embeds (B, P, D) -> + None."""
    return {k: fit_spec(x.shape, (DATA,) + (None,) * (len(x.shape) - 1),
                        mesh)
            for k, x in batch.items()}


_CACHE_RULES = [
    # stacked KV caches (L, B, T, KV, Dh): seq over model (flash-decode)
    (5, (None, DATA, "model", None, None)),
    # MLA latent (L, B, T, R) / rwkv states (L, B, H, Dk) etc.
    (4, (None, DATA, "model", None)),
    (3, (None, DATA, "model")),
    (2, (None, DATA)),
    (1, (DATA,)),
]


def cache_spec_for(name: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of the JAX package's stacked cache leaf ``name``."""
    if re.search(r"wkv$", name) and len(shape) == 5:
        # rwkv state (L, B, H, Dk, Dv): no seq axis; shard heads if possible
        return fit_spec(shape, (None, DATA, "model", None, None), mesh)
    if re.search(r"conv$", name) and len(shape) == 4:
        # (L, B, K-1, W): channel axis over model
        return fit_spec(shape, (None, DATA, None, "model"), mesh)
    for ndim, spec in _CACHE_RULES:
        if len(shape) == ndim:
            return fit_spec(shape, spec, mesh)
    return replicated(len(shape))


def _map_cache(node, fn, ref: Tuple[str, ...] = (), depth: int = 0):
    """``node`` (a port cache) rebuilt with ``fn(tensor, reference
    name, layers)`` at each leaf. A list is the stacked layer axis of
    the JAX package's cache; the hybrid's ``groups`` key has no level
    there; a (k, v) pair's members are ``…/0`` and ``…/1``."""
    if isinstance(node, list):
        return [_map_cache(x, fn, ref, len(node)) for x in node]
    if isinstance(node, tuple):
        return tuple(_map_cache(x, fn, ref + (str(i),), depth)
                     for i, x in enumerate(node))
    if isinstance(node, Mapping):
        return {k: _map_cache(v, fn, ref if k == "groups" else ref + (k,),
                              depth) for k, v in node.items()}
    return fn(node, "/".join(ref), depth)


def cache_specs(cache, mesh):
    """The cache's structure with each tensor's spec in its place."""
    def spec(t, ref, layers):
        return cache_spec_for(ref, (layers,) + tuple(t.shape), mesh)[1:]

    return _map_cache(cache, spec)


def cache_placements(cache, mesh):
    """The cache's structure with each tensor's DTensor placements."""
    def pl(t, ref, layers):
        return placements(
            cache_spec_for(ref, (layers,) + tuple(t.shape), mesh)[1:], mesh)

    return _map_cache(cache, pl)


def cache_reference_specs(cache, mesh) -> Dict[str, Spec]:
    """{reference leaf name: stacked spec} of a port cache: the tree the
    JAX package's ``cache_specs`` gives for the same cache."""
    out: Dict[str, Spec] = {}

    def spec(t, ref, layers):
        out[ref] = cache_spec_for(ref, (layers,) + tuple(t.shape), mesh)

    _map_cache(cache, spec)
    return out


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``, one
    per mesh dimension: ``Shard(d)`` on each mesh axis that tensor dim
    ``d``'s entry names (a dim split over ('pod', 'data') is sharded on
    both, major first, as the JAX package lays it out), ``Replicate()``
    on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{entry} is not in the mesh's axis order "
                             f"{names}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


_DTENSOR = []


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def place(t: torch.Tensor, spec: Optional[Spec], mesh, like=None):
    """``t`` (the full tensor, the same on every rank) as a DTensor with
    the placements of ``spec`` (a template, fitted to ``t``'s shape) or
    of the DTensor ``like``: each rank
    keeps its slice, nothing moves. A DTensor is redistributed instead,
    and returned as it is when it is placed so already."""
    from torch.distributed.tensor import distribute_tensor

    if like is not None:
        pl, mesh = tuple(like.placements), like.device_mesh
    else:
        pl = placements(fit_spec(t.shape, spec, mesh), mesh)
    if is_dtensor(t):
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute(tree, specs, mesh):
    """``tree`` (dicts, lists and tuples of tensors, as a batch, a cache
    or AdamW's moments) with each tensor placed by the spec in the same
    place of ``specs``."""
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh)
    if isinstance(tree, list):
        return [distribute(t, s, mesh) for t, s in zip(tree, specs)]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(distribute(t, s, mesh) for t, s in zip(tree, specs))
    if isinstance(tree, Mapping):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    raise TypeError(f"cannot distribute a {type(tree).__name__}")


def distribute_model(model: nn.Module, specs: Dict[str, Spec], mesh
                     ) -> nn.Module:
    """Replace each of ``model``'s parameters, in place, by a DTensor
    parameter placed by its spec (``requires_grad`` kept)."""
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, nn.Parameter(place(p.data, specs[name], mesh),
                                            requires_grad=p.requires_grad))
    return model


def model_split(n: int, *tensors) -> Optional[str]:
    """``"model"`` when the mesh of the DTensors among ``tensors`` has a
    ``model`` axis of more than one rank that divides ``n`` (heads,
    channels), else ``None``: the entry a template gives such a dim."""
    mesh = next((t.device_mesh for t in tensors if is_dtensor(t)), None)
    if mesh is None:
        return None
    m = mesh_axes(mesh).get("model", 1)
    return "model" if m > 1 and n % m == 0 else None


def local_call(fn, args: Sequence, in_templates: Sequence,
               out_templates: Sequence, partial=()):
    """``fn`` on each rank's shards: the counterpart of a ``shard_map``
    body. Without a DTensor among ``args`` it is ``fn(*args)``.

    Otherwise each tensor argument with a template is placed by
    ``fit_spec(shape, template)`` (a plain tensor, the same on every
    rank, is sliced; a DTensor redistributed) and passed to ``fn`` as
    its local shard; an argument whose template is ``None`` passes as
    it is. Each output becomes a DTensor by its out template, whose
    entries are ``None``, an axis name, or ``(i, d)``: the placement of
    argument ``i``'s dim ``d``; on the mesh axes named in ``partial``
    (``True``: every axis that splits an argument) the outputs are
    partial sums (each rank's part, summed where they are next
    redistributed). A replicated argument used where another
    is split over a mesh axis takes a partial gradient there, as a
    ``shard_map`` body's does; a split one its shard's."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    specs: List[Optional[Spec]] = []
    for a, tpl in zip(args, in_templates):
        if tpl is None or not isinstance(a, torch.Tensor):
            specs.append(None)
        else:
            specs.append(fit_spec(a.shape, tpl, mesh))
    pls = [None if sp is None else placements(sp, mesh) for sp in specs]
    split = [any(pl is not None and not pl[i].is_replicate() for pl in pls)
             for i in range(mesh.ndim)]
    locals_ = []
    for a, sp, pl in zip(args, specs, pls):
        if sp is None:
            locals_.append(a)
            continue
        grad_pl = tuple(Partial() if (p.is_replicate() and split[i])
                        else p for i, p in enumerate(pl))
        locals_.append(place(a, sp, mesh).to_local(grad_placements=grad_pl))
    out = fn(*locals_)
    single = not isinstance(out, tuple)
    res = []
    for o, tpl in zip((out,) if single else out, out_templates):
        if tpl is None:
            res.append(o)
            continue
        spec = tuple(specs[e[0]][e[1]]
                     if isinstance(e, tuple) and isinstance(e[0], int) else e
                     for e in tpl)
        pl = list(placements(spec, mesh))
        names = list(mesh.mesh_dim_names)
        for i in range(mesh.ndim):
            if (partial is True and split[i]) or (
                    partial is not True and names[i] in partial):
                pl[i] = Partial()
        res.append(DTensor.from_local(o, mesh, tuple(pl), run_check=False))
    return res[0] if single else tuple(res)


def full(x):
    """The whole tensor of a DTensor on every rank; any other as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Activation policy (residual-stream constraint at the layer boundary)
# ---------------------------------------------------------------------------

_policy = threading.local()


@contextlib.contextmanager
def activation_policy(mesh, *, seq_axis: Optional[str] = "model",
                      shard_residual_seq: bool = True):
    """While active, :func:`constrain_residual` redistributes a (B, S, D)
    DTensor residual stream to (DATA, seq_axis, None), Megatron-style
    sequence sharding of the layer boundary, and :func:`constrain` a
    DTensor to a fitted template. Plain tensors pass untouched."""
    prev = getattr(_policy, "value", None)
    dp = data_axes(mesh)
    _policy.value = {
        "mesh": mesh,
        "spec": (dp if dp else None,
                 seq_axis if shard_residual_seq else None,
                 None),
    }
    try:
        yield
    finally:
        _policy.value = prev


def active_mesh():
    """The mesh of the active activation policy (None outside steps)."""
    pol = getattr(_policy, "value", None)
    return None if pol is None else pol["mesh"]


def constrain(x, spec_template: Sequence):
    """``x`` redistributed to ``fit_spec(x.shape, spec_template)`` while
    a policy is live and ``x`` is a DTensor; else ``x``."""
    pol = getattr(_policy, "value", None)
    if pol is None or not is_dtensor(x):
        return x
    mesh = pol["mesh"]
    return x.redistribute(mesh, placements(
        fit_spec(x.shape, spec_template, mesh), mesh))


def pad(x, widths: Sequence[int], value: float = 0.0):
    """``F.pad(x, widths, value=value)``; a DTensor is padded per rank,
    batch over the data axes and the other dims whole (DTensor has no
    rule for the pad)."""
    import torch.nn.functional as F

    rest = (None,) * (x.ndim - 1)
    return local_call(lambda t: F.pad(t, widths, value=value), (x,),
                      ((DATA,) + rest,), (((0, 0),) + rest,))


def whole_seq(x):
    """``x`` (B, S, ...) with its sequence whole on every rank (batch
    over the data axes) while a policy is live: the gather before a
    product, Megatron-style sequence parallelism's, which also keeps a
    product's input free of a sharded dimension it would flatten."""
    return constrain(x, (DATA,) + (None,) * (x.ndim - 1))


def constrain_residual(x):
    """Apply the active residual-stream constraint (no-op outside a
    policy, on a plain tensor, or off a 3-d one)."""
    pol = getattr(_policy, "value", None)
    if pol is None or x.ndim != 3:
        return x
    return constrain(x, pol["spec"])


# ---------------------------------------------------------------------------
# Scenario-axis sharding (pathfinding sweeps)
# ---------------------------------------------------------------------------

Mesh = Any          # a DeviceMesh, or a tuple of one torch.device


def _group_live() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def scenario_mesh(min_devices: int = 2,
                  torch_device: DeviceLike = None) -> Optional[Mesh]:
    """The mesh a scenario grid's cells are split over: a 1-D ``('data',)``
    ``DeviceMesh`` over the ranks of the live process group, on
    ``torch_device``'s type (``None`` = cuda, which raises without a
    GPU); without a group, the tuple of the one device of that type
    (the CPU, or this process's card). ``None`` when there are fewer
    than ``min_devices`` ranks."""
    dev = resolve_device(torch_device)
    if _group_live():
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        n = dist.get_world_size()
        if n < min_devices:
            return None
        return init_device_mesh(dev.type, (n,), mesh_dim_names=("data",))
    if dev.type == "cuda":
        mesh = (torch.device("cuda", torch.cuda.current_device()),)
    else:
        mesh = (torch.device(dev.type),)
    return mesh if len(mesh) >= min_devices else None


def _one_device(mesh: tuple) -> torch.device:
    """The device of a tuple mesh, which holds one: only a DeviceMesh
    over a process group splits the cells."""
    if len(mesh) != 1:
        raise ValueError(
            f"a mesh of {len(mesh)} devices as a tuple: the cells split "
            "only over the ranks of a process group (a DeviceMesh)")
    return mesh[0]


def mesh_ranks(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) on a scenario mesh."""
    if isinstance(mesh, tuple):
        _one_device(mesh)
        return 0, 1
    return mesh.get_local_rank(), mesh.size()


def mesh_device_of(mesh: Mesh) -> torch.device:
    """The device this rank places its work on."""
    if isinstance(mesh, tuple):
        return _one_device(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def scenario_block(n_cells: int, mesh: Mesh) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of an ``n_cells`` grid this rank keeps:
    ``[r·S/n, (r+1)·S/n)`` on rank r of n when n divides S, else all of
    them (the JAX package's ``fit_spec`` replicates a dimension an axis
    does not divide)."""
    r, n = mesh_ranks(mesh)
    if n > 1 and n_cells % n == 0:
        b = n_cells // n
        return r * b, (r + 1) * b
    return 0, n_cells


def shard_scenarios(arrays: Dict[str, object],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each array (numpy or torch) as a tensor on this rank's device,
    dtype kept, holding its block of rows of the leading (scenario) axis
    (:func:`scenario_block`; every row when the ranks do not divide the
    count, so ragged grids still run)."""
    dev = mesh_device_of(mesh)
    out = {}
    for k, x in arrays.items():
        t = torch.as_tensor(x, device=dev)
        lo, hi = scenario_block(t.shape[0], mesh)
        out[k] = t if (lo, hi) == (0, t.shape[0]) else t[lo:hi]
    return out


def gather_scenarios(x: torch.Tensor, mesh: Mesh, n_cells: int,
                     dim: int = 0) -> torch.Tensor:
    """The whole grid's rows from each rank's block of ``x`` along
    ``dim`` (the inverse of :func:`shard_scenarios`); ``x`` itself when
    this rank holds every row."""
    lo, hi = scenario_block(n_cells, mesh)
    if (lo, hi) == (0, n_cells):
        return x
    import torch.distributed as dist

    group = mesh.get_group()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
