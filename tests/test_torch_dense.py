"""The dense family (GQA with qk-norm or QKV bias, SwiGLU): the port's
attention layer and whole model against the reference's, on the reduced
``qwen3-8b`` (qk-norm), ``qwen2.5-14b`` (QKV bias) and ``smollm-135m``
(tied embeddings, 4 query heads over 2 KV heads) configs: d_model 64,
heads of 16, 2 layers, vocabulary 128.

The reference's ``init_model`` draws the projections; it inits the
biases to zero and every norm weight to one, which would leave qk-norm's
and the biases' weights unexercised. So each subject's biases and norm
weights (``ln1``, ``ln2``, ``final_norm``, ``q_norm``, ``k_norm``) are
drawn with numpy from a seed and put into the reference's tree before
it computes; ``lm_params_from_reference`` carries the whole tree over.

- Blocks, on layer 0's attention: ``_project_qkv``; ``gqa_forward``
  with small chunks (8/16) at S = 37, causal and not (the encoder-only
  mask); ``gqa_prefill`` (output and the right-padded cache);
  ``gqa_decode`` from a random cache with per-row lengths that differ
  (output and the whole cache after the per-row write).
- The model: ``forward``, ``prefill`` (logits and cache) and four
  teacher-forced ``decode_step``s (the port's argmax equal to the
  reference's wherever the reference's top-2 gap exceeds the
  tolerance), and a decode continued from a converted reference cache.
- ``param_count`` of the four full configs, equal to the reference's;
  ``SHAPES`` and ``applicable`` for every ported architecture.
- bfloat16: ``qwen2.5-14b`` reduced with the same weights rounded to
  bf16, ``DTypePolicy.bf16()`` on both sides, ``forward``, ``prefill``
  and two decode steps.

Tolerance: 2e-5 of the reference output's max |value| in float32 (both
sides compute in float32 and differ by summation order; measured on the
CPU: at most 1.2e-6). In bfloat16: 2e-2 of max |value|, since the two
sides round their 16-bit products and sums at different points
(measured on the CPU: at most 1.03e-2, a layer-1 cache row).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config
from repro_torch.convert import cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

RTOL = 2e-5
BF16_RTOL = 2e-2
SUBJECTS = {"qwen3": "qwen3-8b", "qwen25": "qwen2.5-14b",
            "smollm": "smollm-135m"}
FULL = ("smollm-135m", "yi-6b", "qwen3-8b", "qwen2.5-14b")
B, S, STEPS = 2, 24, 4
ATT_S, DEC_T = 37, 20
DEC_LEN = (1, 13, 19)
BF16_STEPS = 2


def _cfg(tag):
    return get_config(SUBJECTS[tag]).reduced()


def _inputs():
    rng = np.random.default_rng(23)

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    inp = {"full": np.array(FULL), "ported": np.array(ARCH_NAMES),
           "tags": np.array(list(SUBJECTS)),
           "names": np.array(list(SUBJECTS.values())),
           "steps": np.array(STEPS), "bf16_steps": np.array(BF16_STEPS),
           "dec_len": np.array(DEC_LEN, dtype=np.int32)}
    for tag in SUBJECTS:
        cfg = _cfg(tag)
        L, d, h, kv, dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_head)
        # non-default norm weights and biases
        for name, shape in (("ln1", (L, d)), ("ln2", (L, d)),
                            ("final_norm", (d,))):
            inp[f"{tag}_{name}"] = n(*shape, scale=0.2, shift=1.0)
        if cfg.qk_norm:
            inp[f"{tag}_q_norm"] = n(L, dh, scale=0.3, shift=1.0)
            inp[f"{tag}_k_norm"] = n(L, dh, scale=0.3, shift=1.0)
        if cfg.qkv_bias:
            inp[f"{tag}_bq"] = n(L, h * dh, scale=0.5)
            inp[f"{tag}_bk"] = n(L, kv * dh, scale=0.5)
            inp[f"{tag}_bv"] = n(L, kv * dh, scale=0.5)
        inp[f"{tag}_x"] = n(B, ATT_S, d)
        inp[f"{tag}_x1"] = n(3, 1, d)
        inp[f"{tag}_ck"] = n(3, DEC_T, kv, dh)
        inp[f"{tag}_cv"] = n(3, DEC_T, kv, dh)
        inp[f"{tag}_tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)
    return inp


REF = FLAT + """
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import attention as attn
from repro.models.common import DTypePolicy
from repro.models.transformer import decode_step, forward, init_model, prefill

from repro.configs import SHAPES, applicable

J = jnp.asarray
for name in inp["full"]:
    out[f"count/{name}"] = np.array(get_config(str(name)).param_count())
out["shapes"] = np.array([[c.name, c.kind, str(c.seq_len),
                           str(c.global_batch)] for c in SHAPES])
for name in inp["ported"]:
    for c in SHAPES:
        ok, why = applicable(get_config(str(name)), c)
        out[f"applicable/{name}/{c.name}"] = np.array([str(ok), why])
jf = jax.jit(forward, static_argnums=(1,))
jp = jax.jit(prefill, static_argnums=(1, 3, 4))
jd = jax.jit(decode_step, static_argnums=(1,))
steps = int(inp["steps"])


def run(pre, params, cfg, toks, steps, policy=DTypePolicy()):
    f32 = lambda a: np.asarray(a, np.float32)
    out[pre + "forward"] = f32(jf(params, cfg, toks)[0])
    logits, cache, length = jp(params, cfg, toks, toks.shape[1] + steps,
                               policy)
    out[pre + "prefill"], out[pre + "length"] = f32(logits), length
    out.update(flat({"kv": jax.tree_util.tree_map(f32, cache["kv"])},
                    pre + "cache/"))
    for i in range(steps):
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = jd(params, cfg, token, cache, length)
        length = length + 1
        out[pre + f"tok{i}"], out[pre + f"step{i}"] = token, f32(logits)
    out.update(flat({"kv": jax.tree_util.tree_map(f32, cache["kv"])},
                    pre + "cache_end/"))


for i, (tag, name) in enumerate(zip(inp["tags"], inp["names"])):
    tag, cfg = str(tag), get_config(str(name)).reduced()
    params = init_model(jax.random.PRNGKey(40 + i), cfg)
    lay = params["layers"]
    lay["ln1"], lay["ln2"] = J(inp[tag + "_ln1"]), J(inp[tag + "_ln2"])
    params["final_norm"] = J(inp[tag + "_final_norm"])
    for k in ("q_norm", "k_norm", "bq", "bk", "bv"):
        if f"{tag}_{k}" in inp:
            lay["attn"][k] = J(inp[f"{tag}_{k}"])
    out.update(flat(params, f"{tag}/p/"))
    a0 = jax.tree_util.tree_map(lambda a: a[0], lay["attn"])
    x = J(inp[tag + "_x"])
    pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
    q, k, v = attn._project_qkv(a0, x, cfg)
    out[tag + "/q"], out[tag + "/k"], out[tag + "/v"] = q, k, v
    for causal in (True, False):
        out[f"{tag}/gqa_causal{int(causal)}"] = attn.gqa_forward(
            a0, x, pos, cfg, causal=causal, q_chunk=8, kv_chunk=16)
    y, (ck, cv) = attn.gqa_prefill(a0, x, pos, cfg, x.shape[1] + 5,
                                   q_chunk=8, kv_chunk=16)
    out[tag + "/prefill_y"], out[tag + "/prefill_k"] = y, ck
    out[tag + "/prefill_v"] = cv
    y, (ck, cv) = attn.gqa_decode(
        a0, J(inp[tag + "_x1"]), (J(inp[tag + "_ck"]), J(inp[tag + "_cv"])),
        J(inp["dec_len"]), cfg)
    out[tag + "/decode_y"], out[tag + "/decode_k"] = y, ck
    out[tag + "/decode_v"] = cv
    run(tag + "/", params, cfg, J(inp[tag + "_tokens"]), steps)
    if tag == "qwen25":
        pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        run("bf16/", pb, cfg, J(inp[tag + "_tokens"]),
            int(inp["bf16_steps"]), DTypePolicy.bf16())
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, _inputs(), tmp_path_factory.mktemp("ref_dense"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for tag in SUBJECTS:
        cfg = _cfg(tag)
        model = init_model(cfg, torch_device="cpu")
        model.load_state_dict(lm_params_from_reference(
            nest(ref, f"{tag}/p/"), cfg))
        out[tag] = model
    return out


@pytest.fixture(scope="module")
def inp():
    return {k: torch.as_tensor(v) for k, v in _inputs().items()
            if v.dtype.kind != "U"}


def _close(got, want, what, rtol=RTOL):
    got = got.detach().float().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


def _same_argmax_where_clear(got, want, rtol=RTOL):
    """Port and reference pick the same token wherever the reference's
    top-2 gap exceeds the tolerance."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > rtol * np.abs(want).max()
    assert np.array_equal(got.float().argmax(-1).numpy()[clear],
                          want.argmax(-1)[clear])


def _positions(x):
    return torch.arange(x.shape[1]).expand(x.shape[:2])


TAGS = list(SUBJECTS)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FULL)
def test_param_count_matches_reference(ref, name):
    cfg = get_config(name)
    assert cfg.family == "dense"
    assert cfg.param_count() == int(ref[f"count/{name}"])


def test_shape_cells_and_applicability_match_reference(ref):
    """``SHAPES`` and ``applicable`` for every ported architecture: the
    full-attention dense configs skip ``long_500k``; the recurrent ones
    (``sub_quadratic``) run it."""
    assert [[c.name, c.kind, str(c.seq_len), str(c.global_batch)]
            for c in SHAPES] == ref["shapes"].tolist()
    for name in ARCH_NAMES:
        for c in SHAPES:
            ok, why = applicable(get_config(name), c)
            assert [str(ok), why] == \
                ref[f"applicable/{name}/{c.name}"].tolist(), (name, c.name)
    assert not applicable(get_config("qwen3-8b"), SHAPES[-1])[0]
    assert applicable(get_config("rwkv6-3b"), SHAPES[-1])[0]


def test_reduced_keeps_the_family_features():
    for tag, (qk_norm, qkv_bias, tied) in (
            ("qwen3", (True, False, False)), ("qwen25", (False, True, False)),
            ("smollm", (False, False, True))):
        cfg = _cfg(tag)
        assert (cfg.qk_norm, cfg.qkv_bias, cfg.tie_embeddings) == \
            (qk_norm, qkv_bias, tied)
        assert (cfg.n_layers, cfg.d_model, cfg.d_head, cfg.max_seq) == \
            (2, 64, 16, 512)


@pytest.mark.parametrize("tag", TAGS)
def test_subjects_exercise_biases_and_norm_weights(models, tag):
    """Guards the test's own design: the loaded weights are not the
    reference's defaults (zero biases, unit norms)."""
    model, cfg = models[tag], _cfg(tag)
    attn0 = model.layers[0].attn
    assert not torch.all(model.layers[0].ln1 == 1)
    assert not torch.all(model.final_norm == 1)
    if cfg.qk_norm:
        assert not torch.all(attn0.q_norm == 1)
        assert not torch.all(attn0.k_norm == 1)
    if cfg.qkv_bias:
        assert bool(attn0.bq.abs().min() > 0) and bool(attn0.bv.any())
    assert hasattr(model, "lm_head") is not cfg.tie_embeddings


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_project_qkv_matches_reference(ref, models, inp, tag):
    q, k, v = attn_mod._project_qkv(models[tag].layers[0].attn,
                                    inp[f"{tag}_x"], _cfg(tag))
    for got, name in ((q, "q"), (k, "k"), (v, "v")):
        _close(got, ref[f"{tag}/{name}"], name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("tag", TAGS)
def test_gqa_forward_matches_reference(ref, models, inp, tag, causal):
    x = inp[f"{tag}_x"]
    y = attn_mod.gqa_forward(models[tag].layers[0].attn, x, _positions(x),
                             _cfg(tag), causal=causal, q_chunk=8,
                             kv_chunk=16)
    _close(y, ref[f"{tag}/gqa_causal{int(causal)}"], "gqa")


@pytest.mark.parametrize("tag", TAGS)
def test_gqa_prefill_matches_reference(ref, models, inp, tag):
    x = inp[f"{tag}_x"]
    y, (ck, cv) = attn_mod.gqa_prefill(
        models[tag].layers[0].attn, x, _positions(x), _cfg(tag),
        ATT_S + 5, q_chunk=8, kv_chunk=16)
    _close(y, ref[f"{tag}/prefill_y"], "y")
    _close(ck, ref[f"{tag}/prefill_k"], "cache k")
    _close(cv, ref[f"{tag}/prefill_v"], "cache v")
    assert not ck[:, ATT_S:].any() and not cv[:, ATT_S:].any()


@pytest.mark.parametrize("tag", TAGS)
def test_gqa_decode_writes_each_row_at_its_length(ref, models, inp, tag):
    ck, cv = inp[f"{tag}_ck"].clone(), inp[f"{tag}_cv"].clone()
    length = inp["dec_len"]
    y, (nk, nv) = attn_mod.gqa_decode(models[tag].layers[0].attn,
                                      inp[f"{tag}_x1"], (ck, cv), length,
                                      _cfg(tag))
    _close(y, ref[f"{tag}/decode_y"], "y")
    _close(nk, ref[f"{tag}/decode_k"], "cache k")
    _close(nv, ref[f"{tag}/decode_v"], "cache v")
    assert nk.data_ptr() == ck.data_ptr()         # written in place
    for r, n in enumerate(DEC_LEN):               # one row each, at n
        keep = torch.ones(DEC_T, dtype=torch.bool)
        keep[n] = False
        assert torch.equal(nk[r, keep], inp[f"{tag}_ck"][r, keep])
        assert torch.equal(nv[r, keep], inp[f"{tag}_cv"][r, keep])
        assert not torch.equal(nk[r, n], inp[f"{tag}_ck"][r, n])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _compare_cache(got, want_ref, cfg, what, rtol=RTOL):
    want = cache_from_reference(want_ref, cfg)
    assert len(got["kv"]) == len(want["kv"]) == cfg.n_layers
    for (gk, gv), (wk, wv) in zip(got["kv"], want["kv"]):
        _close(gk, wk.numpy(), f"{what} k", rtol)
        _close(gv, wv.numpy(), f"{what} v", rtol)


@pytest.mark.parametrize("tag", TAGS)
def test_forward_matches_reference(ref, models, inp, tag):
    logits, aux = forward(models[tag], inp[f"{tag}_tokens"])
    _close(logits, ref[f"{tag}/forward"], "logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("tag", TAGS)
def test_prefill_and_decode_match_reference(ref, models, inp, tag):
    model, pre = models[tag], f"{tag}/"
    logits, cache, length = prefill(model, inp[f"{tag}_tokens"], S + STEPS)
    _close(logits, ref[pre + "prefill"], "prefill logits")
    _same_argmax_where_clear(logits, ref[pre + "prefill"])
    assert length.dtype == torch.int32
    np.testing.assert_array_equal(length.numpy(), ref[pre + "length"])
    _compare_cache(cache, nest(ref, pre + "cache/"), model.cfg, "prefill")
    for i in range(STEPS):
        token = torch.as_tensor(ref[pre + f"tok{i}"])
        logits, cache = decode_step(model, token, cache, length)
        length = length + 1
        _close(logits, ref[pre + f"step{i}"], f"step {i} logits")
        _same_argmax_where_clear(logits, ref[pre + f"step{i}"])
    _compare_cache(cache, nest(ref, pre + "cache_end/"), model.cfg, "end")


@pytest.mark.parametrize("tag", TAGS)
def test_decode_from_converted_reference_cache(ref, models, tag):
    """A reference cache carried over by ``cache_from_reference``
    continues the port's decode like its own."""
    model, pre = models[tag], f"{tag}/"
    cache = cache_from_reference(nest(ref, pre + "cache/"), model.cfg)
    logits, _ = decode_step(model, torch.as_tensor(ref[pre + "tok0"]),
                            cache, torch.as_tensor(ref[pre + "length"]))
    _close(logits, ref[pre + "step0"], "step 0 logits")


@pytest.mark.parametrize("tag", TAGS)
def test_lm_params_cover_the_model_exactly(ref, models, tag):
    sd = lm_params_from_reference(nest(ref, f"{tag}/p/"), _cfg(tag))
    assert set(sd) == set(models[tag].state_dict())
    for k, t in models[tag].state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    assert ("lm_head" in sd) is not _cfg(tag).tie_embeddings


def test_init_cache_shapes():
    cfg = _cfg("qwen3")
    cache = init_cache(cfg, 3, 20, torch_device="cpu")
    assert len(cache["kv"]) == cfg.n_layers
    for k, v in cache["kv"]:
        assert k.shape == v.shape == (3, 20, cfg.n_kv_heads, cfg.d_head)
        assert not k.any() and not v.any()
    bf = init_cache(cfg, 1, 4, DTypePolicy.bf16(), torch_device="cpu")
    assert bf["kv"][0][0].dtype == torch.bfloat16


def test_decode_from_zero_cache_equals_one_token_prefill(models):
    """A zero cache is the empty context: one decode step from it is a
    prefill of that one token."""
    model = models["qwen25"]
    token = torch.tensor([5, 77], dtype=torch.int32)
    cache = init_cache(model.cfg, 2, 8, torch_device="cpu")
    logits, _ = decode_step(model, token, cache,
                            torch.zeros(2, dtype=torch.int32))
    want, _, _ = prefill(model, token[:, None], 8)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)


def test_dense_entry_points_need_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = _cfg("smollm")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "2",
                    "--gen", "1"])


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_model(models):
    model = init_model(_cfg("qwen25"), DTypePolicy.bf16(), torch_device="cpu")
    model.load_state_dict(models["qwen25"].state_dict())    # rounds to bf16
    return model


def test_bf16_model_holds_bf16_and_scores_in_float32(bf16_model, inp):
    assert all(p.dtype == torch.bfloat16 for p in bf16_model.parameters())
    q = inp["qwen25_x"][:, :8].reshape(B, 8, 1, 4, 16).bfloat16()
    k = inp["qwen25_x"][:, 8:16].reshape(B, 8, 4, 16)[:, :, :1].bfloat16()
    mask = torch.zeros(8, 8)
    m, o, l = attn_mod._attend_chunk(q, k, k, mask, 0.25)
    assert m.dtype == o.dtype == l.dtype == torch.float32


def test_bf16_forward_prefill_decode_match_reference(ref, bf16_model, inp):
    toks = inp["qwen25_tokens"]
    logits, _ = forward(bf16_model, toks)
    assert logits.dtype == torch.bfloat16
    _close(logits, ref["bf16/forward"], "bf16 logits", BF16_RTOL)
    logits, cache, length = prefill(bf16_model, toks, S + BF16_STEPS)
    _close(logits, ref["bf16/prefill"], "bf16 prefill", BF16_RTOL)
    assert cache["kv"][0][0].dtype == torch.bfloat16
    _compare_cache(cache, nest(ref, "bf16/cache/"), bf16_model.cfg,
                   "bf16 prefill", BF16_RTOL)
    for i in range(BF16_STEPS):
        token = torch.as_tensor(ref[f"bf16/tok{i}"])
        logits, cache = decode_step(bf16_model, token, cache, length)
        length = length + 1
        _close(logits, ref[f"bf16/step{i}"], f"bf16 step {i}", BF16_RTOL)
        _same_argmax_where_clear(logits, ref[f"bf16/step{i}"], BF16_RTOL)


@pytest.mark.cuda
def test_cuda_dense_matches_cpu():
    """The reduced qwen2.5 (QKV bias) and qwen3 (qk-norm) on the card
    against the same weights on the CPU: prefill of 24 tokens and 4
    teacher-forced decode steps, within 1e-4 of max |logit| (cuBLAS sums
    in other orders than the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for tag in ("qwen25", "qwen3"):
        cfg = dataclasses.replace(_cfg(tag), d_model=256)
        cpu = init_model(cfg, seed=5, torch_device="cpu")
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                if name.endswith(("norm", "ln1", "ln2", "bq", "bk", "bv")):
                    p.add_(torch.randn(p.shape, generator=torch.Generator()
                                       .manual_seed(len(name))) * 0.3)
        gpu = init_model(cfg, torch_device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        toks = torch.as_tensor(_inputs()[f"{tag}_tokens"])
        lc, cc, nc = prefill(cpu, toks, S + STEPS)
        lg, cg, ng = prefill(gpu, toks.cuda(), S + STEPS)
        for i in range(STEPS + 1):
            scale = float(lc.abs().max())
            assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * scale, i
            if i == STEPS:
                break
            token = lc.argmax(-1).to(torch.int32)
            lc, cc = decode_step(cpu, token, cc, nc)
            lg, cg = decode_step(gpu, token.cuda(), cg, ng)
            nc, ng = nc + 1, ng + 1
