"""Training the moe family against the reference: the reduced
``deepseek-v2-236b`` (MLA, a leading dense layer, then a MoE layer of
one shared and 8 routed experts, top-2) and the reduced
``llama4-maverick-400b-a17b`` (a GQA dense layer, then a GQA MoE layer,
top-1), d_model 64, batch 4 x 32 tokens.

The experts run with the capacity drops (``int(T k / E x 1.25) + 1``
pairs an expert) and the loss adds 0.01 x the load-balancing loss. The
gradient of a dropped pair is zero, the router's flows through the
softmax over the top-k logits only and the load-balancing counts take
none, as ``jax.grad`` of the reference's dispatch gives them. The first
step's batch overflows at least one expert in each config, so the drops
are in the gradients held against the reference.

Five steps, the first step's gradients and the checkpoints both ways, by
``tests/test_torch_train_support.py`` (its docstring gives the
tolerances).
"""
import pytest
import torch

from test_torch_train_support import (
    cfg_of,
    check_decay_mask,
    check_first_step_gradients,
    check_five_steps,
    check_port_checkpoint,
    check_reference_checkpoint,
    pipe_of,
    run_family_reference,
)

from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import init_model, loss_fn

TAGS = ("deepseek", "llama4")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_family_reference(TAGS, tmp_path_factory)


def _drops(monkeypatch, tag):
    """Pairs over their expert's capacity in the first step's forward
    (the routing of every MoE layer, as ``moe_forward`` computes it)."""
    cfg = cfg_of(tag)
    real, drops = moe_mod._route, []

    def route(logits, top_k):
        gates, idx = real(logits, top_k)
        t = idx.shape[0]
        cap = int(t * top_k / cfg.n_experts * cfg.capacity_factor) + 1
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
        drops.append(int((counts - cap).clamp(min=0).sum()))
        return gates, idx

    monkeypatch.setattr(moe_mod, "_route", route)
    model = init_model(cfg, torch_device="cpu", seed=0)
    loss_fn(model, pipe_of(tag).batch(0))
    return drops


@pytest.mark.parametrize("tag", TAGS)
def test_five_steps_match_reference(ref, tag):
    check_five_steps(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_first_step_gradients_match_reference(ref, tag):
    check_first_step_gradients(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_first_batch_overflows_an_expert(tag, monkeypatch):
    drops = _drops(monkeypatch, tag)
    assert len(drops) == 1                     # one MoE layer, no remat
    assert drops[0] > 0, f"{tag}: no pair over capacity"


@pytest.mark.parametrize("tag", TAGS)
def test_decay_mask_matches_reference(ref, tag):
    check_decay_mask(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_reference_checkpoint_restores_into_the_port(ref, tag):
    check_reference_checkpoint(*ref, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_port_checkpoint_restores_into_the_reference(ref, tag):
    check_port_checkpoint(ref[0], tag)


def test_dropped_pairs_take_no_gradient():
    """A capacity of 1 drops all but each expert's first pair: the
    experts' weights get gradient from the kept pairs only, and a token
    whose every pair dropped gets its gradient from the shared expert
    alone."""
    cfg = cfg_of("deepseek")
    model = init_model(cfg, torch_device="cpu", seed=1, trainable=True)
    layer = model.moe_layers[0].moe
    x = torch.randn(1, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2), requires_grad=True)
    y = moe_mod.moe_forward(layer, x, cfg, capacity=1)
    gx, = torch.autograd.grad(y.sum(), x)
    shared = moe_mod.mlp_forward(layer.shared, x.reshape(24, -1))
    gs, = torch.autograd.grad(shared.sum(), x)
    gates, idx = moe_mod._route(moe_mod._router_logits(
        layer, x.detach().reshape(24, -1)), cfg.top_k)
    order = torch.argsort(idx.reshape(-1), stable=True)
    first = torch.ones(order.shape[0], dtype=torch.bool)
    first[1:] = idx.reshape(-1)[order][1:] != idx.reshape(-1)[order][:-1]
    kept = torch.zeros(order.shape[0], dtype=torch.bool)
    kept[order] = first
    kept_tokens = kept.reshape(24, cfg.top_k).any(1)
    assert kept_tokens.any() and not kept_tokens.all()
    assert torch.equal(gx[0, ~kept_tokens], gs[0, ~kept_tokens])
    assert not torch.equal(gx[0, kept_tokens], gs[0, kept_tokens])
