"""Feed-forward layers: the dense SwiGLU MLP and the capacity-based
top-k mixture of experts.

The torch counterpart of the JAX package's ``models/moe.py``. Routing is
the same: top-k over the float32 router logits (ties to the lower
index), a softmax over the selected logits, the (token, k) pairs sorted
stably by expert, and a pair kept when its slot in its expert's run is
under the capacity. The JAX package then fills an (E, capacity, D)
buffer and runs every expert over it; here only the routed pairs are
computed: one gather of the tokens in expert order, then for each
expert that holds a pair, its three products on its contiguous run,
reading ``w_gate[e]``, ``w_up[e]`` and ``w_down[e]`` only. An empty slot
of the reference's buffer is a zero row and SwiGLU without bias maps
zero to zero, so the result is the same function. The run lengths come
to the host to slice the runs: one device-to-host sync a MoE layer a
call. Each token's k weighted contributions are gathered into (T, k, D)
and summed by one reduction (a fixed order, where a scatter-add on the
card adds in the order the threads arrive).

The same code takes gradients (training runs it with the capacity
drops): each run's product is a new tensor and the runs are
concatenated in expert order, with zero rows for the pairs over the
capacity, which therefore contribute nothing and take no gradient, as
in the JAX package's masked dispatch. Under autograd the expert weights
are split once per call (``unbind``), so the backward of each expert's
slice does not allocate a zero tensor of the whole (E, D, F) leaf;
serving indexes only the experts it runs (a decode step a handful of
the E). The gathers whose backward adds rows (the tokens into expert
order, the selected router logits) are ``F.embedding`` and
``torch.gather``, which add in a fixed order on the CPU and under
deterministic algorithms on the card.

Under an activation policy whose mesh has a ``model`` axis of more than
one rank that divides the experts, training and prefill run the JAX
package's expert-parallel dispatch (:func:`moe_forward_ep`): experts
split over ``model``, tokens replicated over it, each rank routing its
tokens to its own experts (:func:`_ep_shard`, a plain function of the
rank and the rank count) and the partial outputs summed over
``model``. Decode (``serving=True``, a handful of tokens) keeps the
local dispatch, as the JAX package's does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import DTypePolicy, FrozenParams, normal_init

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(d_model: int, d_ff: int, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    dt = policy.param_dtype
    return {
        "w_gate": normal_init((d_model, d_ff), 1.0, dt, generator, device),
        "w_up": normal_init((d_model, d_ff), 1.0, dt, generator, device),
        "w_down": normal_init((d_ff, d_model), 1.0, dt, generator, device),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    x = shd.whole_seq(x)
    gate = F.silu(x @ p.w_gate)
    return shd.constrain_residual((gate * (x @ p.w_up)) @ p.w_down)


class MLP(FrozenParams):
    def __init__(self, d_model: int, d_ff: int,
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_mlp(d_model, d_ff, policy, generator, device))


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _experts_init(shape, dtype, generator, device) -> torch.Tensor:
    """(E, fan_in, fan_out) expert weights. In a 16-bit dtype they are
    drawn one expert at a time, so a full-width layer never holds a
    float32 copy of all its experts (llama4's would be 21.5 GB); a
    float32 draw is the result itself, and a meta tensor holds no data,
    so those are one draw."""
    if dtype == torch.float32 or torch.device(device or "cpu").type == "meta":
        return normal_init(shape, 1.0, dtype, generator, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = normal_init(shape[1:], 1.0, dtype, generator, device)
    return out


def init_moe(cfg: ModelConfig, policy: DTypePolicy,
             generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    """The router (float32 whatever the policy, as the JAX package's),
    then the experts' ``w_gate``, ``w_up`` (E, D, F) and ``w_down``
    (E, F, D)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = policy.param_dtype
    return {
        "router": normal_init((d, e), 1.0, torch.float32, generator, device),
        "w_gate": _experts_init((e, d, f), dt, generator, device),
        "w_up": _experts_init((e, d, f), dt, generator, device),
        "w_down": _experts_init((e, f, d), dt, generator, device),
    }


class MoE(FrozenParams):
    """Router and routed experts, plus ``shared`` (an MLP of
    ``moe_d_ff * n_shared_experts``) when the config has shared
    experts."""

    def __init__(self, cfg: ModelConfig, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_moe(cfg, policy, generator, device))
        if cfg.n_shared_experts:
            self.shared = MLP(cfg.d_model,
                              cfg.moe_d_ff * cfg.n_shared_experts, policy,
                              generator, device)


def _top_k(logits: torch.Tensor, k: int):
    """The k largest of each row, largest first, ties to the lower index
    (``jax.lax.top_k``'s order; a stable descending sort keeps it). The
    values are gathered from ``logits``, so their gradient reaches the
    selected logits only."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(logits, -1, idx), idx


def _route(router_logits: torch.Tensor, top_k: int):
    """Top-k routing with softmax over the selected experts' logits:
    (gates (T, k) float32, expert ids (T, k))."""
    gates, idx = _top_k(router_logits, top_k)
    return torch.softmax(gates, dim=-1), idx


def _router_logits(p, xf: torch.Tensor) -> torch.Tensor:
    return xf.float() @ p.router


def _run_starts(runs: torch.Tensor, pairs: int, e: int) -> list:
    """The start of each expert's run and the end of the last, on the
    host. A ``meta`` tensor holds no routing: there every pair counts as
    routed, none dropped, spread as evenly as whole pairs go over the
    experts (so the work counted reads every expert that gets one)."""
    if runs.device.type == "meta":
        return [i * pairs // e for i in range(e + 1)]
    return runs.tolist()


def _capacity(t: int, cfg: ModelConfig, exact: bool) -> int:
    """The JAX package's capacity of ``t`` tokens: ``t * k`` when exact,
    else ``int(t * k / E * capacity_factor) + 1``."""
    k, e = cfg.top_k, cfg.n_experts
    return t * k if exact else int(t * k / e * cfg.capacity_factor) + 1


def _ep_axis(cfg: ModelConfig) -> int:
    """The ``model`` axis size the expert-parallel dispatch runs over
    under the live policy, or 0 where the local dispatch runs."""
    mesh = shd.active_mesh()
    if mesh is None:
        return 0
    ep = shd.mesh_axes(mesh).get("model", 1)
    return ep if ep > 1 and cfg.n_experts % ep == 0 else 0


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig,
                capacity: Optional[int] = None, exact: bool = False,
                serving: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Pairs over an expert's capacity are
    dropped (their token keeps the shared experts and the residual);
    ``exact=True`` (prefill and decode) sizes the capacity so nothing
    drops. The capacity is the JAX package's: ``T * k`` when exact, else
    ``int(T * k / E * capacity_factor) + 1``. Under a policy whose mesh
    splits the experts over ``model`` (and not ``serving``) the
    expert-parallel dispatch runs (:func:`moe_forward_ep`), with the
    capacity of each rank's tokens. On ``meta`` (shape-only counting)
    the routing is not known: every token's top-k pairs count as routed,
    spread evenly over the experts and none dropped
    (:func:`_run_starts`), so the bytes counted read every expert that a
    share of the pairs reaches."""
    if not serving and _ep_axis(cfg):
        return moe_forward_ep(p, x, cfg, shd.active_mesh(), exact=exact)
    if shd.is_dtensor(x):
        return _moe_forward_stationary(p, x, cfg, capacity, exact)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    gates, expert_idx = _route(_router_logits(p, xf), k)   # (T,k), (T,k)
    if capacity is None:
        capacity = _capacity(t, cfg, exact)

    # (token, k) pairs sorted stably by expert: each expert's pairs form a
    # contiguous run, in token order, and the first `capacity` are kept
    flat_expert = expert_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    runs = torch.searchsorted(flat_expert[order],
                              torch.arange(e + 1, device=x.device))
    runs = _run_starts(runs, t * k, e)      # the one host sync of the call
    xs = F.embedding(order // k, xf)                        # (T*k, D)
    w_gate, w_up, w_down = p.w_gate, p.w_up, p.w_down
    if torch.is_grad_enabled() and w_gate.requires_grad:
        w_gate, w_up, w_down = (w.unbind(0) for w in (w_gate, w_up, w_down))
    pieces = []
    for ex in range(e):
        start, n = runs[ex], runs[ex + 1] - runs[ex]
        kept = min(n, capacity)
        if kept:
            xe = xs[start:start + kept]
            h = F.silu(xe @ w_gate[ex]) * (xe @ w_up[ex])
            pieces.append(h @ w_down[ex])
        if n > kept:                        # dropped: zero rows
            pieces.append(x.new_zeros((n - kept, d)))
    hs = torch.cat(pieces)                                  # (T*k, D)
    # back to (token, k) order, then weighted by the gates
    unsorted = torch.empty_like(hs).index_copy_(0, order, hs)
    contrib = unsorted * gates.reshape(-1, 1).to(x.dtype)
    y = contrib.reshape(t, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + mlp_forward(p.shared, xf)
    return y.reshape(b, s, d)


def _ep_shard(router, w_gate, w_up, w_down, x: torch.Tensor,
              cfg: ModelConfig, rank: int, ep: int, exact: bool = False,
              capacity: Optional[int] = None) -> torch.Tensor:
    """One rank's part of the expert-parallel dispatch, a plain function
    of ``(rank, ep)``: ``x`` (B, S, D) this rank's tokens (all of them on
    every rank of the ``model`` group), ``router`` (D, E) whole, and the
    rank's ``E / ep`` experts ``w_gate``, ``w_up`` (E_loc, D, F) and
    ``w_down`` (E_loc, F, D). Each token's top-k pairs that reach this
    rank's experts are kept up to the rank's capacity (``T * k`` when
    exact, else ``int(T * k / E * capacity_factor) + 1`` of its T
    tokens), in expert then token order; the result (B, S, D) is this
    rank's weighted sum, which summed over the ranks is the layer's
    routed output. No shared experts. ``capacity`` overrides the
    rank's. The expert width F may be a slice of the experts' (the
    serving layout): the sum over the ranks holding the other slices
    completes the down projection."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // ep
    t = b * s
    xf = x.reshape(t, d)
    gates, idx = _route(xf.float() @ router, k)             # (T,k), (T,k)
    cap = _capacity(t, cfg, exact) if capacity is None else capacity
    flat = idx.reshape(-1)
    lo = rank * e_loc
    # this rank's experts 0..e_loc-1; the other pairs go to bucket e_loc
    le = torch.where((flat >= lo) & (flat < lo + e_loc), flat - lo, e_loc)
    order = torch.argsort(le, stable=True)
    if x.device.type == "meta":
        # no routing on meta: the rank's share of the pairs, spread evenly
        mine = t * k // ep
        runs = [i * mine // e_loc for i in range(e_loc + 1)]
    else:
        runs = torch.searchsorted(le[order], torch.arange(
            e_loc + 1, device=x.device)).tolist()
    xs = F.embedding(order // k, xf)                        # (T*k, D)
    if torch.is_grad_enabled() and w_gate.requires_grad:
        w_gate, w_up, w_down = (w.unbind(0) for w in (w_gate, w_up, w_down))
    # every expert runs, on an empty run too, so each rank's graph (and
    # the collectives its backward runs) is the same whatever routes
    rows, outs = [], []
    for ex in range(e_loc):
        start, n = runs[ex], runs[ex + 1] - runs[ex]
        kept = min(n, cap)
        xe = xs[start:start + kept]
        h = F.silu(xe @ w_gate[ex]) * (xe @ w_up[ex])
        outs.append(h @ w_down[ex])
        rows.append(order[start:start + kept])
    pair = torch.cat(rows)                           # (token, k) indices
    hs = torch.cat(outs) * gates.reshape(-1)[pair, None].to(x.dtype)
    return x.new_zeros((t, d)).index_add(0, pair // k, hs).reshape(b, s, d)


def moe_forward_ep(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                   exact: bool = False) -> torch.Tensor:
    """Expert-parallel MoE (the JAX package's ``shard_map`` path): on
    DTensors, the experts split over ``mesh``'s ``model`` axis, the
    tokens replicated over it (batch over the data axes). Each rank runs
    :func:`_ep_shard` on its tokens and experts; the partial outputs are
    summed over ``model``, by a reduce-scatter onto the sequence-sharded
    residual when ``model`` divides S, else by one all-reduce. Then the
    shared experts are added."""
    ep = shd.mesh_axes(mesh)["model"]
    if not shd.is_dtensor(x):
        x = shd.place(x, shd.replicated(3), mesh)
    rank = mesh.get_local_rank("model")
    body = functools.partial(_ep_shard, cfg=cfg, rank=rank, ep=ep,
                             exact=exact)
    tok = (shd.DATA, None, None)
    experts = ("model", None, None)

    y = shd.local_call(body, (p.router, p.w_gate, p.w_up, p.w_down, x),
                       ((None, None), experts, experts, experts, tok),
                       (((4, 0), None, None),), partial=("model",))
    seq = "model" if x.shape[1] % ep == 0 else None
    y = shd.place(y, shd.fit_spec(y.shape, (shd.DATA, seq, None), mesh), mesh)
    if cfg.n_shared_experts:
        y = y + mlp_forward(p.shared, x)
    return y


def _moe_forward_stationary(p, x: torch.Tensor, cfg: ModelConfig,
                            capacity: Optional[int], exact: bool
                            ) -> torch.Tensor:
    """The local dispatch on DTensors (decode, or experts that ``model``
    does not divide): every rank routes all the tokens to the experts
    and the expert-width slices it holds, the weights stay where they
    lie, and the partial outputs are summed over the ranks, the small
    activation all-reduce of the JAX package's serving layout."""
    mesh = x.device_mesh
    m = shd.mesh_axes(mesh).get("model", 1)
    ep = m if m > 1 and cfg.n_experts % m == 0 else 1
    rank = mesh.get_local_rank("model") if ep > 1 else 0
    if capacity is None and not exact:
        capacity = _capacity(x.shape[0] * x.shape[1], cfg, False)
    e_ax = "model" if ep > 1 else None
    body = functools.partial(_ep_shard, cfg=cfg, rank=rank, ep=ep,
                             exact=exact, capacity=capacity)
    y = shd.local_call(
        body, (p.router, p.w_gate, p.w_up, p.w_down, x),
        ((None, None), (e_ax, None, shd.DATA), (e_ax, None, shd.DATA),
         (e_ax, shd.DATA, None), (None, None, None)),
        ((None, None, None),), partial=True)
    y = shd.place(y, shd.fit_spec(y.shape, (shd.DATA, None, None), mesh),
                  mesh)
    if cfg.n_shared_experts:
        y = y + mlp_forward(p.shared, x)
    return y


def moe_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style: E * sum(f_e * p_e)),
    float32. Its gradient flows through the router probabilities only:
    the counts of routed pairs take none."""
    b, s, d = x.shape
    if shd.is_dtensor(x):
        # each rank's token counts and probability sums, summed over the
        # ranks that split the tokens
        counts, psum = shd.local_call(
            functools.partial(_aux_sums, cfg=cfg), (x, p.router),
            ((shd.DATA, "model", None), (None, None)),
            ((None,), (None,)), partial=True)
        frac_probs = psum / (b * s)
    else:
        logits = _router_logits(p, x.reshape(b * s, d))
        probs = torch.softmax(logits, dim=-1)
        counts = _expert_counts(logits, cfg)
        frac_probs = probs.mean(dim=0)
    frac_tokens = counts / counts.sum()
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


def _expert_counts(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """How many of the tokens' top-k pairs go to each expert (float32)."""
    idx = _top_k(logits, cfg.top_k)[1].reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                         device=logits.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx)).float()


def _aux_sums(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(expert counts, router probabilities summed over tokens) of the
    tokens ``x`` (..., D)."""
    logits = x.reshape(-1, x.shape[-1]).float() @ router
    return (_expert_counts(logits, cfg),
            torch.softmax(logits, dim=-1).sum(dim=0))
