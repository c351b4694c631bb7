"""The vlm (``internvl2-26b``) and audio (``hubert-xlarge``) families
against the reference's.

- Both configs equal the reference's field by field, full and
  ``reduced()`` (the reference's one extra field, its cost-probe switch
  ``unroll_layers``, is False), with equal ``param_count``.
- Reduced models (2 layers, d_model 64, vocabulary 128; the vlm prefix
  cut to 4 rows) with the reference's weights and every norm weight drawn
  non-default: ``forward`` of the vlm on a 4-row patch-embedding prefix
  and 12 tokens, and on the tokens alone; of the audio encoder on 12
  frame embeddings (bidirectional); ``eval_step`` equal to ``forward``.
- The vlm backbone serving on its token stream (no image prefix, as in
  the reference): ``prefill`` (logits and cache) and four teacher-forced
  decode steps through ``prefill_step`` and ``serve_step``.
- The audio family has no decode step: ``init_cache``, ``prefill`` and
  ``decode_step`` raise ``ValueError``, and the serve and train CLIs
  refuse both families with the reference CLIs' messages.

Tolerance: 2e-5 of the reference's max |value| in float32 (both sides
compute in float32 and differ in summation order; measured on the CPU:
at most 1.1e-6, the vlm forward with its prefix).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.convert import cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve, train
from repro_torch.launch.steps import eval_step, prefill_step, serve_step
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

RTOL = 2e-5
NAMES = {"vlm": "internvl2-26b", "audio": "hubert-xlarge"}
B, S, STEPS = 2, 12, 4


def _cfg(tag):
    return get_config(NAMES[tag]).reduced()


def _inputs():
    rng = np.random.default_rng(29)

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    inp = {}
    for tag in NAMES:
        cfg = _cfg(tag)
        L, d = cfg.n_layers, cfg.d_model
        for name, shape in (("ln1", (L, d)), ("ln2", (L, d)),
                            ("final_norm", (d,))):
            inp[f"{tag}_{name}"] = n(*shape, scale=0.2, shift=1.0)
    vlm = _cfg("vlm")
    inp["vlm_tokens"] = rng.integers(0, vlm.vocab, (B, S)).astype(np.int32)
    inp["vlm_embeds"] = n(B, vlm.frontend_prefix, vlm.d_model)
    inp["audio_embeds"] = n(B, S, _cfg("audio").d_model)
    return inp


REF = FLAT + """
import dataclasses, json
import jax.numpy as jnp
from repro.configs import get_config
from repro.models.transformer import decode_step, forward, init_model, prefill

J = jnp.asarray
for i, (tag, name) in enumerate(NAMES.items()):
    full = get_config(name)
    out[f"cfg/{tag}"] = np.array(json.dumps(dataclasses.asdict(full)))
    out[f"cfg_reduced/{tag}"] = np.array(json.dumps(
        dataclasses.asdict(full.reduced())))
    out[f"count/{tag}"] = np.array(full.param_count())
    cfg = full.reduced()
    params = init_model(jax.random.PRNGKey(70 + i), cfg)
    lay = params["layers"]
    lay["ln1"], lay["ln2"] = J(inp[tag + "_ln1"]), J(inp[tag + "_ln2"])
    params["final_norm"] = J(inp[tag + "_final_norm"])
    out.update(flat(params, f"{tag}/p/"))
    if tag == "vlm":
        toks, emb = J(inp["vlm_tokens"]), J(inp["vlm_embeds"])
        out["vlm/forward_prefix"] = forward(params, cfg, toks, emb)[0]
        out["vlm/forward_tokens"] = forward(params, cfg, toks)[0]
        logits, cache, length = prefill(params, cfg, toks, S + STEPS)
        out["vlm/prefill"] = logits
        out.update(flat({"kv": {"k": cache["kv"][0], "v": cache["kv"][1]}},
                        "vlm/cache/"))
        for s in range(STEPS):
            token = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = decode_step(params, cfg, token, cache, length)
            length = length + 1
            out[f"vlm/tok{s}"], out[f"vlm/step{s}"] = token, logits
    else:
        out["audio/forward"] = forward(params, cfg, None,
                                       J(inp["audio_embeds"]))[0]
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    consts = f"NAMES = {NAMES!r}\nS = {S}\nSTEPS = {STEPS}\n"
    return run_reference(consts + REF, _inputs(),
                         tmp_path_factory.mktemp("ref_vlm_audio"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for tag in NAMES:
        model = init_model(_cfg(tag), torch_device="cpu")
        model.load_state_dict(lm_params_from_reference(
            nest(ref, f"{tag}/p/"), _cfg(tag)))
        out[tag] = model
    return out


@pytest.fixture(scope="module")
def inp():
    return {k: torch.as_tensor(v) for k, v in _inputs().items()}


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("tag", list(NAMES))
def test_config_equals_reference_field_by_field(ref, tag, reduced):
    cfg = get_config(NAMES[tag])
    if reduced:
        cfg = cfg.reduced()
    want = json.loads(str(ref[f"cfg{'_reduced' if reduced else ''}/{tag}"]))
    got = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert set(want) - set(got) == {"unroll_layers"}
    assert not want["unroll_layers"]
    assert set(got) <= set(want)
    for k, v in got.items():
        assert v == want[k], (k, v, want[k])
    assert cfg.family == tag and cfg.encoder_only == (tag == "audio")


@pytest.mark.parametrize("tag", list(NAMES))
def test_param_count_matches_reference(ref, tag):
    assert get_config(NAMES[tag]).param_count() == int(ref[f"count/{tag}"])


def test_full_models_hold_their_published_sizes():
    """Built on the meta device: ``param_count`` (19,860,664,320 for
    internvl2-26b, 39.7 GB in bf16; 1,259,581,440 for hubert-xlarge) plus
    the norm weights it leaves out, 2 a layer and the final one."""
    for name in NAMES.values():
        cfg = get_config(name)
        model = LM(cfg, DTypePolicy(), None, torch.device("meta"))
        norms = (2 * cfg.n_layers + 1) * cfg.d_model
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() + norms
    assert get_config("internvl2-26b").param_count() == 19_860_664_320
    assert get_config("hubert-xlarge").param_count() == 1_259_581_440


def test_vlm_forward_with_prefix_matches_reference(ref, models, inp):
    logits, aux = forward(models["vlm"], inp["vlm_tokens"],
                          inp["vlm_embeds"])
    assert logits.shape == (B, 4 + S, 128) and float(aux) == 0.0
    _close(logits, ref["vlm/forward_prefix"], "prefix")
    batch = {"tokens": inp["vlm_tokens"], "embeds": inp["vlm_embeds"]}
    assert torch.equal(eval_step(models["vlm"], batch), logits)


def test_vlm_forward_on_tokens_matches_reference(ref, models, inp):
    _close(forward(models["vlm"], inp["vlm_tokens"])[0],
           ref["vlm/forward_tokens"], "tokens")


def test_audio_forward_matches_reference(ref, models, inp):
    logits, _ = forward(models["audio"], embeds=inp["audio_embeds"])
    _close(logits, ref["audio/forward"], "audio")
    assert torch.equal(eval_step(models["audio"],
                                 {"embeds": inp["audio_embeds"]}), logits)


def test_audio_attends_both_ways(models, inp):
    """Bidirectional: changing the last frame changes the first
    position's logits (a causal model's would not move)."""
    emb = inp["audio_embeds"]
    moved = emb.clone()
    moved[:, -1] += 1.0
    a = forward(models["audio"], embeds=emb)[0]
    b = forward(models["audio"], embeds=moved)[0]
    assert not torch.allclose(a[:, 0], b[:, 0])


def test_vlm_prefill_and_decode_match_reference(ref, models, inp):
    model, cfg = models["vlm"], _cfg("vlm")
    logits, cache, length = prefill_step(
        model, {"tokens": inp["vlm_tokens"]}, S + STEPS)
    _close(logits, ref["vlm/prefill"], "prefill")
    want = cache_from_reference(
        {"kv": tuple(ref[f"vlm/cache/kv/{x}"] for x in "kv")}, cfg)
    for (k, v), (wk, wv) in zip(cache["kv"], want["kv"]):
        _close(k, wk, "cache k")
        _close(v, wv, "cache v")
    for s in range(STEPS):
        token = torch.as_tensor(ref[f"vlm/tok{s}"])
        assert torch.equal(logits.argmax(-1).to(torch.int32), token)
        nxt, logits, cache, length = serve_step(model, cache, token, length)
        _close(logits, ref[f"vlm/step{s}"], f"step {s}")
        assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))


def test_audio_has_no_decode_step(models, inp):
    cfg = _cfg("audio")
    with pytest.raises(ValueError, match="encoder-only"):
        init_cache(cfg, 1, 8, torch_device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(models["audio"], torch.zeros((1, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(models["audio"], torch.zeros(1, dtype=torch.int32), {},
                    torch.zeros(1, dtype=torch.int32))
    assert len(init_cache(_cfg("vlm"), 1, 8, torch_device="cpu")["kv"]) == 2


@pytest.mark.parametrize("name,message", [
    ("hubert-xlarge", "encoder-only architectures have no decode step"),
    ("internvl2-26b", "vlm serving runs via the dry-run decode cells")])
def test_serve_cli_refuses(name, message):
    with pytest.raises(SystemExit, match=message):
        serve.main(["--arch", name, "--device", "cpu", "--reduced"])


@pytest.mark.parametrize("name", list(NAMES.values()))
def test_train_cli_refuses(name):
    with pytest.raises(SystemExit, match="audio/vlm run via the dry-run"):
        train.main(["--arch", name, "--device", "cpu", "--reduced"])
