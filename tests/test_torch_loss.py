"""The port's ``loss_fn`` and its gradients against
``jax.value_and_grad`` of the reference's ``loss_fn``.

Subjects, reduced (2 layers, d_model 64, vocabulary 128): ``smollm-135m``
(dense, tied embeddings), ``qwen2.5-14b`` (dense, untied, QKV bias),
``internvl2-26b`` (vlm: a 4-row patch-embedding prefix before the
tokens, the loss on the text positions only) and ``hubert-xlarge``
(audio: bidirectional layers over frame embeddings, no tokens, so the
token embedding takes a zero gradient). The reference's ``init_model``
draws the weights; every norm weight and QKV bias is drawn non-default
with numpy and the whole tree carried over. Each batch has 12 label
positions, a third of them ``-100``, and the loss runs in chunks of 5,
so the last chunk is padded (15 positions).

Tolerance: 1e-5 of the reference's max |value| for the loss and for
each gradient leaf, in float32 (both sides differ in summation order
only; measured on the CPU: at most 2.8e-6, a qwen2.5 gradient leaf).

Also: ``remat=True`` (each layer and each loss chunk recomputed in the
backward) gives the same loss and gradients to the bit, and the default
chunk (1024, one unpadded chunk here) agrees with the chunked one.
"""
import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models.transformer import init_model, loss_fn

RTOL = 1e-5
B, S, CHUNK = 2, 12, 5
SUBJECTS = {"smollm": "smollm-135m", "qwen25": "qwen2.5-14b",
            "vlm": "internvl2-26b", "audio": "hubert-xlarge"}


def _cfg(tag):
    return get_config(SUBJECTS[tag]).reduced()


def _inputs():
    rng = np.random.default_rng(17)

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    inp = {}
    for tag in SUBJECTS:
        cfg = _cfg(tag)
        L, d, h, kv, dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_head)
        for name, shape in (("ln1", (L, d)), ("ln2", (L, d)),
                            ("final_norm", (d,))):
            inp[f"{tag}_{name}"] = n(*shape, scale=0.2, shift=1.0)
        if cfg.qkv_bias:
            for name, width in (("bq", h * dh), ("bk", kv * dh),
                                ("bv", kv * dh)):
                inp[f"{tag}_{name}"] = n(L, width, scale=0.5)
        labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels[rng.random((B, S)) < 1 / 3] = -100
        inp[f"{tag}_labels"] = labels
        if cfg.family != "audio":
            inp[f"{tag}_tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32)
        if cfg.family == "vlm":
            inp[f"{tag}_embeds"] = n(B, cfg.frontend_prefix, d)
        if cfg.family == "audio":
            inp[f"{tag}_embeds"] = n(B, S, d)
    return inp


REF = FLAT + """
import jax.numpy as jnp
from repro.configs import get_config
from repro.models.transformer import init_model, loss_fn

J = jnp.asarray
for i, (tag, name) in enumerate(SUBJECTS.items()):
    cfg = get_config(name).reduced()
    params = init_model(jax.random.PRNGKey(60 + i), cfg)
    lay = params["layers"]
    lay["ln1"], lay["ln2"] = J(inp[tag + "_ln1"]), J(inp[tag + "_ln2"])
    params["final_norm"] = J(inp[tag + "_final_norm"])
    for k in ("bq", "bk", "bv"):
        if f"{tag}_{k}" in inp:
            lay["attn"][k] = J(inp[f"{tag}_{k}"])
    out.update(flat(params, f"{tag}/p/"))
    batch = {k: J(inp[f"{tag}_{k}"]) for k in ("tokens", "embeds", "labels")
             if f"{tag}_{k}" in inp}
    f = jax.jit(jax.value_and_grad(loss_fn), static_argnums=(1, 3))
    loss, grads = f(params, cfg, batch, CHUNK)
    out[f"{tag}/loss"] = loss
    out.update(flat(grads, f"{tag}/g/"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    consts = f"SUBJECTS = {SUBJECTS!r}\nCHUNK = {CHUNK}\n"
    return run_reference(consts + REF, _inputs(),
                         tmp_path_factory.mktemp("ref_loss"))


def _model(ref, tag):
    cfg = _cfg(tag)
    model = init_model(cfg, torch_device="cpu", trainable=True)
    model.load_state_dict(lm_params_from_reference(nest(ref, f"{tag}/p/"),
                                                   cfg))
    return model


def _batch(tag):
    inp = _inputs()
    return {k: torch.as_tensor(inp[f"{tag}_{k}"])
            for k in ("tokens", "embeds", "labels") if f"{tag}_{k}" in inp}


def _loss_and_grads(model, batch, **kw):
    params = dict(model.named_parameters())
    loss = loss_fn(model, batch, **kw)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


@pytest.mark.parametrize("tag", list(SUBJECTS))
def test_loss_and_gradients_match_reference(ref, tag):
    model = _model(ref, tag)
    loss, grads = _loss_and_grads(model, _batch(tag), loss_chunk=CHUNK)
    _close(loss, ref[f"{tag}/loss"], "loss")
    want = lm_params_from_reference(nest(ref, f"{tag}/g/"), _cfg(tag))
    assert set(want) == set(grads)
    for k in want:
        _close(grads[k], want[k], f"grad {k}")
    if tag == "audio":            # no token reaches the embedding
        assert not grads["embed"].any()
    else:
        assert grads["embed"].abs().max() > 0


@pytest.mark.parametrize("tag", ["smollm", "vlm", "audio"])
def test_remat_gives_the_same_gradients(ref, tag):
    model = _model(ref, tag)
    loss, grads = _loss_and_grads(model, _batch(tag), loss_chunk=CHUNK)
    loss_r, grads_r = _loss_and_grads(model, _batch(tag), loss_chunk=CHUNK,
                                      remat=True)
    assert torch.equal(loss, loss_r)
    for k in grads:
        assert torch.equal(grads[k], grads_r[k]), k


@pytest.mark.parametrize("tag", ["qwen25", "vlm"])
def test_one_unpadded_chunk_agrees(ref, tag):
    model = _model(ref, tag)
    loss, _ = _loss_and_grads(model, _batch(tag))
    _close(loss, ref[f"{tag}/loss"], "loss")


def test_masked_labels_do_not_count(ref):
    """Labels of -100 add nothing: dropping them to -100 in one row
    gives the loss of the other row alone."""
    model = _model(ref, "smollm")
    batch = _batch("smollm")
    one = {k: v[:1] for k, v in batch.items()}
    masked = dict(batch, labels=batch["labels"].clone())
    masked["labels"][1] = -100
    with torch.no_grad():
        a = loss_fn(model, one, loss_chunk=CHUNK)
        b = loss_fn(model, masked, loss_chunk=CHUNK)
    assert torch.allclose(a, b, rtol=1e-6)


def test_a_serving_model_evaluates_the_loss_without_a_graph(ref):
    cfg = _cfg("smollm")
    model = init_model(cfg, torch_device="cpu")
    model.load_state_dict(lm_params_from_reference(nest(ref, "smollm/p/"),
                                                   cfg))
    loss = loss_fn(model, _batch("smollm"), loss_chunk=CHUNK)
    assert not loss.requires_grad
    _close(loss, ref["smollm/loss"], "loss")
