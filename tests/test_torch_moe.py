"""The mixture of experts (``models/moe.py``): the port's router and
dispatch against the reference's, on the reduced ``deepseek-v2-236b``
(8 experts, top-2, one shared expert), the same with no shared expert,
and the reduced ``llama4-maverick-400b-a17b`` (top-1, one shared): d_model
64, expert width 32, 80 tokens (B 2 x S 40).

The reference draws the weights (``init_moe``); ``MoE.load_state_dict``
carries them over. The reference's dispatch fills an (E, capacity, D)
buffer and runs every expert over it; the port computes the routed
pairs only, so the tests pin that both give the same function: with
``exact=True`` (nothing drops) and at the default ``capacity_factor``
1.25 (capacity 26 for deepseek's 160 pairs over 8 experts, at an input
seed where pairs do drop), where the pairs the port keeps are the
reference's. A port-only case puts NaN into every expert no token is
routed to: the output stays finite and unchanged.

Tolerance: 2e-5 of the reference output's max |value| in float32 (both
sides compute in float32 and differ by summation order; measured on the
CPU: at most 5.7e-7). In bfloat16: 2e-2 of max |value|. Both sides
round each product and the SwiGLU to bf16, but at different points (the
reference's einsums over the whole buffer, the port's per-expert
products; the reference adds a token's k contributions into a bf16
buffer one at a time, the port sums them in one reduction); measured on
the CPU: at most 6.7e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import DTypePolicy

RTOL = 2e-5
BF16_RTOL = 2e-2
SUBJECTS = {"deepseek": "deepseek-v2-236b", "noshared": "deepseek-v2-236b",
            "llama4": "llama4-maverick-400b-a17b"}
TAGS = list(SUBJECTS)
B, S = 2, 40


def _cfg(tag):
    cfg = get_config(SUBJECTS[tag]).reduced()
    if tag == "noshared":
        cfg = dataclasses.replace(cfg, n_shared_experts=0)
    return cfg


def _inputs():
    rng = np.random.default_rng(5)
    return {"tags": np.array(TAGS), "names": np.array(list(SUBJECTS.values())),
            "x": rng.standard_normal((B, S, 64)).astype(np.float32)}


REF = FLAT + """
import dataclasses
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import moe as moe_mod

f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
x = jnp.asarray(inp["x"])
b, s, d = x.shape
xf = x.reshape(b * s, d)
for tag, name in zip(inp["tags"], inp["names"]):
    tag, cfg = str(tag), get_config(str(name)).reduced()
    if tag == "noshared":
        cfg = dataclasses.replace(cfg, n_shared_experts=0)
    # one key for every subject: deepseek and noshared share the routed
    # weights (init_moe draws the shared expert from its own subkey)
    p = moe_mod.init_moe(jax.random.PRNGKey(7), cfg, moe_mod.DTypePolicy())
    out.update(flat(p, tag + "/p/"))
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), p["router"])
    gates, idx = moe_mod._route(logits, cfg.top_k)
    out[tag + "/gates"], out[tag + "/idx"] = gates, idx
    for exact in (True, False):
        out[f"{tag}/y{int(exact)}"] = moe_mod.moe_forward(p, x, cfg,
                                                          exact=exact)
    # the (token, k) pairs the dispatch keeps at the default capacity,
    # as flat ids token * k + j
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    cap = int(t * k / e * cfg.capacity_factor) + 1
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg = jnp.searchsorted(se, jnp.arange(e), side="left")
    keep = (jnp.arange(t * k) - seg[se]) < cap
    out[tag + "/kept"] = jnp.sort(order[keep])
    out[tag + "/capacity"] = np.array(cap)
    out[tag + "/aux"] = moe_mod.moe_aux_loss(p, x, cfg)
    if tag == "deepseek":
        pb = {kk: v if kk == "router" else jax.tree_util.tree_map(
                  lambda a: a.astype(jnp.bfloat16), v) for kk, v in p.items()}
        for exact in (True, False):
            out[f"bf16/y{int(exact)}"] = f32(moe_mod.moe_forward(
                pb, x.astype(jnp.bfloat16), cfg, exact=exact))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, _inputs(), tmp_path_factory.mktemp("ref_moe"))


def _state_dict(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state_dict(v, f"{pre}{k}."))
        else:
            out[pre + k] = torch.as_tensor(v)
    return out


@pytest.fixture(scope="module")
def layers(ref):
    out = {}
    for tag in TAGS:
        m = moe_mod.MoE(_cfg(tag), device="cpu")
        m.load_state_dict(_state_dict(nest(ref, f"{tag}/p/")))
        out[tag] = m
    return out


@pytest.fixture(scope="module")
def x():
    return torch.as_tensor(_inputs()["x"])


def _close(got, want, what, rtol=RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


def _kept_pairs(idx, cfg, capacity):
    """Flat (token * k + j) ids of the pairs under ``capacity`` in their
    expert's run, the runs in token order: the dispatch's rule."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=cfg.n_experts)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(flat_e.numel()) - start[flat_e[order]]
    return torch.sort(order[slot < capacity]).values


@pytest.mark.parametrize("tag", TAGS)
def test_route_matches_reference(ref, layers, x, tag):
    logits = moe_mod._router_logits(layers[tag], x.reshape(B * S, -1))
    gates, idx = moe_mod._route(logits, _cfg(tag).top_k)
    assert gates.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref[f"{tag}/idx"])
    _close(gates, ref[f"{tag}/gates"], "gates")


def test_top_k_breaks_ties_to_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    vals, idx = moe_mod._top_k(logits, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


@pytest.mark.parametrize("tag", TAGS)
def test_moe_forward_exact_matches_reference(ref, layers, x, tag):
    y = moe_mod.moe_forward(layers[tag], x, _cfg(tag), exact=True)
    _close(y, ref[f"{tag}/y1"], "exact")


@pytest.mark.parametrize("tag", TAGS)
def test_moe_forward_drops_the_reference_pairs(ref, layers, x, tag):
    """At the default capacity factor pairs really drop, and the port
    keeps the reference's pairs: its output equals the reference's and
    differs from the exact one."""
    cfg = _cfg(tag)
    t, k = B * S, cfg.top_k
    cap = int(ref[f"{tag}/capacity"])
    assert cap == int(t * k / cfg.n_experts * cfg.capacity_factor) + 1
    kept = ref[f"{tag}/kept"]
    assert kept.size < t * k                           # some pairs drop
    _, idx = moe_mod._route(moe_mod._router_logits(
        layers[tag], x.reshape(t, -1)), k)
    np.testing.assert_array_equal(_kept_pairs(idx, cfg, cap).numpy(), kept)
    y = moe_mod.moe_forward(layers[tag], x, cfg)
    _close(y, ref[f"{tag}/y0"], "with drops")
    exact = moe_mod.moe_forward(layers[tag], x, cfg, exact=True)
    dropped = sorted(set(range(t * k)) - set(kept.tolist()))
    tokens = torch.tensor(dropped) // k
    assert not torch.allclose(y.reshape(t, -1)[tokens],
                              exact.reshape(t, -1)[tokens])
    y_cap = moe_mod.moe_forward(layers[tag], x, cfg, capacity=cap)
    assert torch.equal(y_cap, y)


def test_shared_expert_adds_its_mlp(layers, x):
    """``deepseek`` and ``noshared`` share the router and routed experts;
    the difference of their outputs is the shared expert's MLP."""
    cfg, p = _cfg("deepseek"), layers["deepseek"]
    assert cfg.n_shared_experts == 1 and hasattr(p, "shared")
    assert not hasattr(layers["noshared"], "shared")
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert torch.equal(getattr(p, name),
                           getattr(layers["noshared"], name))
    diff = moe_mod.moe_forward(p, x, cfg, exact=True) - moe_mod.moe_forward(
        layers["noshared"], x, _cfg("noshared"), exact=True)
    torch.testing.assert_close(diff, moe_mod.mlp_forward(p.shared, x),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_aux_loss_matches_reference(ref, layers, x, tag):
    aux = moe_mod.moe_aux_loss(layers[tag], x, _cfg(tag))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(ref[f"{tag}/aux"])) <= \
        RTOL * abs(float(ref[f"{tag}/aux"]))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "drops"])
def test_bf16_matches_reference(ref, layers, x, exact):
    cfg = _cfg("deepseek")
    m = moe_mod.MoE(cfg, DTypePolicy.bf16(), device="cpu")
    m.load_state_dict(layers["deepseek"].state_dict())   # rounds to bf16
    assert m.router.dtype == torch.float32 and m.w_up.dtype == torch.bfloat16
    y = moe_mod.moe_forward(m, x.bfloat16(), cfg, exact=exact)
    assert y.dtype == torch.bfloat16
    _close(y, ref[f"bf16/y{int(exact)}"], "bf16", BF16_RTOL)


def test_unrouted_experts_are_never_read(layers):
    """NaN in every expert no token is routed to leaves the output
    finite and unchanged: only the routed experts' weights are read."""
    cfg = _cfg("deepseek")
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (1, 3, 64)).astype(np.float32))
    m = moe_mod.MoE(cfg, device="cpu")
    m.load_state_dict(layers["deepseek"].state_dict())
    want = moe_mod.moe_forward(m, x, cfg, exact=True)
    _, idx = moe_mod._route(moe_mod._router_logits(m, x[0]), cfg.top_k)
    unrouted = sorted(set(range(cfg.n_experts)) - set(idx.reshape(-1).tolist()))
    assert len(unrouted) >= 2
    with torch.no_grad():
        for name in ("w_gate", "w_up", "w_down"):
            getattr(m, name)[unrouted] = float("nan")
    got = moe_mod.moe_forward(m, x, cfg, exact=True)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_init_draws_float32_router_and_expert_shapes():
    cfg = _cfg("deepseek")
    gen = torch.Generator().manual_seed(0)
    p = moe_mod.init_moe(cfg, DTypePolicy.bf16(), gen, "cpu")
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (64, 8)
    assert p["w_gate"].shape == p["w_up"].shape == (8, 64, 32)
    assert p["w_down"].shape == (8, 32, 64)
    assert all(p[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_up", "w_down"))
    # one expert at a time: each is a draw with std 1/sqrt(fan_in)
    assert 0.08 < float(p["w_gate"].float().std()) < 0.17
    assert not torch.equal(p["w_gate"][0], p["w_gate"][1])


def test_mesh_of_several_devices_raises(layers, x):
    """A mesh of several ranks no longer raises: the expert-parallel
    split (``_ep_shard`` of each rank of two, their own experts, summed)
    plus the shared experts is the layer's exact output, and
    ``moe_forward`` takes no ``mesh`` (the split runs under an
    activation policy)."""
    cfg = _cfg("llama4")
    p = layers["llama4"]
    e_loc = cfg.n_experts // 2
    with torch.inference_mode():
        parts = [moe_mod._ep_shard(
            p.router, *(w[r * e_loc:(r + 1) * e_loc]
                        for w in (p.w_gate, p.w_up, p.w_down)),
            x, cfg, r, 2, exact=True) for r in range(2)]
        got = parts[0] + parts[1] + moe_mod.mlp_forward(p.shared, x)
        want = moe_mod.moe_forward(p, x, cfg, exact=True)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    with pytest.raises(TypeError, match="mesh"):
        moe_mod.moe_forward(p, x, cfg, mesh=(torch.device("cpu"),) * 2)
