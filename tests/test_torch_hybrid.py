"""The hybrid family (RecurrentGemma): the port's blocks and whole model
against the reference's, with the reference's ``init_model`` weights
carried over by ``lm_params_from_reference`` and its stacked caches by
``cache_from_reference``, on ``recurrentgemma-9b``'s reduced config
(d_model 64, 4 query heads of 16 and 1 KV head, RG-LRU width 64 in 16
gate blocks, window 32).

- Blocks: ``apply_rope`` (interleaved pairs), ``_block_diag``,
  ``_causal_conv`` with and without a carry, ``_rg_lru_coeffs``,
  ``rg_block_forward`` with and without a state; ``chunked_attention``
  with small chunks (8/16) and S = 37, causal and windowed, at KV = 1
  (MQA, the model's) and KV = 2; ``decode_attention``; the windowed
  attention layer (the reference's ``gqa_forward``) with the window
  binding.
- The model at 3 layers (one group, no tail) and 5 layers (one group and
  a 2-layer tail): ``forward``, ``prefill`` and eight ``decode_step``s,
  with a prompt of 20 (inside the window) and of 48 (beyond it, so the
  ring cache is rotated and decode overwrites real slots). Decoding is
  teacher-forced with the reference's greedy tokens; the port's argmax
  must equal the reference's wherever the reference's top-2 gap exceeds
  the tolerance.

Tolerance: 2e-5 of the reference output's max |value|. Both sides
compute in float32 and differ by summation order (matrix products, the
associative against the sequential scan); measured on the CPU: at
most 2.5e-7 on the blocks and 2.2e-6 on the model.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.convert import cache_from_reference, lm_params_from_reference
from repro_torch.kernels.rglru import launch_count
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models.common import apply_rope
from repro_torch.models.transformer import (
    _windowed_prefill,
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

RTOL = 2e-5
LAYERS = (3, 5)
PROMPTS = (20, 48)
B, STEPS = 2, 8
# chunked attention: (KV, G, q_chunk, kv_chunk, window or 0)
ATTN_CASES = [(1, 4, 8, 16, 0), (1, 4, 8, 16, 12), (2, 2, 8, 16, 0),
              (2, 2, 8, 16, 12), (1, 4, 512, 1024, 12)]
ATTN_S, DH = 37, 16
DEC_LAYOUTS = [(1, 4), (2, 2)]


def _cfg(n_layers=3):
    return dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               n_layers=n_layers)


def _inputs():
    rng = np.random.default_rng(13)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    inp = {
        "rope_x": n(2, 11, 4, DH),
        "rope_pos": (np.arange(11)[None] + np.array([[0], [5]])
                     ).astype(np.int32),
        "bd_x": n(2, 7, 64), "bd_w": n(16, 4, 4), "bd_b": n(64),
        "conv_x": n(2, 9, 64), "conv_w": n(4, 64), "conv_b": n(64),
        "conv_state": n(2, 3, 64),
        "rg_x": n(2, 9, 64), "rg_conv": n(2, 3, 64), "rg_h": n(2, 64),
        "gqa_x": n(2, 40, 64),
        "attn_cases": np.array(ATTN_CASES, dtype=np.int32),
        "dec_layouts": np.array(DEC_LAYOUTS, dtype=np.int32),
        "dec_len": np.array([1, 13, 20], dtype=np.int32),
        "layers": np.array(LAYERS), "prompts": np.array(PROMPTS),
        "steps": np.array(STEPS),
    }
    for i, (kv, g, *_rest) in enumerate(ATTN_CASES):
        inp[f"attn{i}_q"] = n(2, ATTN_S, kv, g, DH)
        inp[f"attn{i}_k"] = n(2, ATTN_S, kv, DH)
        inp[f"attn{i}_v"] = n(2, ATTN_S, kv, DH)
    for i, (kv, g) in enumerate(DEC_LAYOUTS):
        inp[f"dec{i}_q"] = n(3, kv, g, DH)
        inp[f"dec{i}_k"] = n(3, 20, kv, DH)
        inp[f"dec{i}_v"] = n(3, 20, kv, DH)
    for s in PROMPTS:
        inp[f"S{s}_tokens"] = rng.integers(0, 128, (B, s)).astype(np.int32)
    return inp


REF = FLAT + """
import dataclasses
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import attention as attn
from repro.models import rglru as rg
from repro.models.common import apply_rope
from repro.models.transformer import decode_step, forward, init_model, prefill

J = jnp.asarray
base = get_config("recurrentgemma-9b").reduced()
out["rope"] = apply_rope(J(inp["rope_x"]), J(inp["rope_pos"]))
out["bdiag"] = rg._block_diag(J(inp["bd_x"]), J(inp["bd_w"]), J(inp["bd_b"]))
for tag, st in (("zero", None), ("carry", J(inp["conv_state"]))):
    y, ns = rg._causal_conv(J(inp["conv_x"]), J(inp["conv_w"]),
                            J(inp["conv_b"]), st)
    out[f"conv_{tag}/y"], out[f"conv_{tag}/state"] = y, ns
for i, (kv, g, qc, kc, win) in enumerate(inp["attn_cases"].tolist()):
    q, k, v = (J(inp[f"attn{i}_{n}"]) for n in "qkv")
    out[f"attn{i}"] = attn.chunked_attention(
        q, k, v, causal=True, window=win or None, q_chunk=qc, kv_chunk=kc)
for i in range(len(inp["dec_layouts"])):
    q, k, v = (J(inp[f"dec{i}_{n}"]) for n in "qkv")
    out[f"dec{i}"] = attn.decode_attention(q, k, v,
                                           length=J(inp["dec_len"]))
jf = jax.jit(forward, static_argnums=(1,))
jp = jax.jit(prefill, static_argnums=(1, 3))
jd = jax.jit(decode_step, static_argnums=(1,))
steps = int(inp["steps"])
for L in inp["layers"]:
    L = int(L)
    cfg = dataclasses.replace(base, n_layers=L)
    params = init_model(jax.random.PRNGKey(L), cfg)
    out.update(flat(params, f"L{L}/p/"))
    if L == 3:
        g0 = jax.tree_util.tree_map(lambda a: a[0], params["groups"])
        blk = g0["rg1"]["block"]
        x = J(inp["rg_x"])
        a, b = rg._rg_lru_coeffs(blk, x)
        out["coeffs/a"], out["coeffs/b"] = a, b
        for tag, st in (("zero", None),
                        ("carry", (J(inp["rg_conv"]), J(inp["rg_h"])))):
            y, (conv, h) = rg.rg_block_forward(blk, x, cfg, st)
            out[f"rg_{tag}/y"], out[f"rg_{tag}/conv"] = y, conv
            out[f"rg_{tag}/h"] = h
        gx = J(inp["gqa_x"])
        pos = jnp.broadcast_to(jnp.arange(gx.shape[1]), gx.shape[:2])
        out["gqa"] = attn.gqa_forward(g0["attn"]["attn"], gx, pos, cfg,
                                      causal=True, window=cfg.local_window)
    for s in inp["prompts"]:
        s = int(s)
        pre = f"L{L}S{s}/"
        toks = J(inp[f"S{s}_tokens"])
        out[pre + "forward"] = jf(params, cfg, toks)[0]
        logits, cache, length = jp(params, cfg, toks, s + steps)
        out[pre + "prefill"], out[pre + "length"] = logits, length
        out.update(flat(cache, pre + "cache/"))
        for i in range(steps):
            token = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = jd(params, cfg, token, cache, length)
            length = length + 1
            out[pre + f"tok{i}"], out[pre + f"step{i}"] = token, logits
        out.update(flat(cache, pre + "cache_end/"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, _inputs(),
                         tmp_path_factory.mktemp("ref_hybrid"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for n_layers in LAYERS:
        cfg = _cfg(n_layers)
        model = init_model(cfg, torch_device="cpu")
        model.load_state_dict(
            lm_params_from_reference(nest(ref, f"L{n_layers}/p/"), cfg))
        out[n_layers] = model
    return out


@pytest.fixture(scope="module")
def inp():
    return {k: torch.as_tensor(v) for k, v in _inputs().items()}


def _close(got, want, what):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


def _same_argmax_where_clear(got, want):
    """Port and reference pick the same token wherever the reference's
    top-2 gap exceeds the tolerance."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > RTOL * np.abs(want).max()
    assert np.array_equal(got.argmax(-1).numpy()[clear],
                          want.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_apply_rope_matches_reference(ref, inp):
    _close(apply_rope(inp["rope_x"], inp["rope_pos"]), ref["rope"], "rope")


def test_rope_rotates_interleaved_pairs():
    """Position 1 turns pair (0, 1) by angle 1 (frequency 1 for i = 0):
    the pair is adjacent lanes, not lane 0 and lane Dh/2."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    y = apply_rope(x, torch.ones(1, 1, dtype=torch.int32))[0, 0, 0]
    assert torch.allclose(y[:2], torch.tensor([np.cos(1.0), np.sin(1.0)],
                                              dtype=torch.float32))
    assert torch.equal(y[2:], torch.zeros(6))


def test_block_diag_matches_reference(ref, inp):
    _close(rg_mod._block_diag(inp["bd_x"], inp["bd_w"], inp["bd_b"]),
           ref["bdiag"], "block diag")


@pytest.mark.parametrize("tag", ["zero", "carry"])
def test_causal_conv_matches_reference(ref, inp, tag):
    st = inp["conv_state"] if tag == "carry" else None
    y, new = rg_mod._causal_conv(inp["conv_x"], inp["conv_w"],
                                 inp["conv_b"], st)
    _close(y, ref[f"conv_{tag}/y"], "conv y")
    _close(new, ref[f"conv_{tag}/state"], "conv state")
    assert torch.equal(new, inp["conv_x"][:, -3:])


def test_rg_lru_coeffs_match_reference(ref, inp, models):
    a, b = rg_mod._rg_lru_coeffs(models[3].groups[0].rg1.block, inp["rg_x"])
    assert a.dtype == b.dtype == torch.float32
    assert bool(((a > 0) & (a < 1)).all())
    _close(a, ref["coeffs/a"], "a")
    _close(b, ref["coeffs/b"], "b")


@pytest.mark.parametrize("tag", ["zero", "carry"])
def test_rg_block_matches_reference(ref, inp, models, tag):
    blk = models[3].groups[0].rg1.block
    h0 = inp["rg_h"].clone()
    st = (inp["rg_conv"], h0) if tag == "carry" else None
    y, (conv, h) = rg_mod.rg_block_forward(blk, inp["rg_x"], _cfg(3), st)
    _close(y, ref[f"rg_{tag}/y"], "y")
    _close(conv, ref[f"rg_{tag}/conv"], "conv state")
    _close(h, ref[f"rg_{tag}/h"], "h")
    assert h.dtype == torch.float32
    if st is not None:                         # the slab, updated in place
        assert h.data_ptr() == h0.data_ptr()


@pytest.mark.parametrize("i", range(len(ATTN_CASES)),
                         ids=["kv{}g{}q{}k{}w{}".format(*c)
                              for c in ATTN_CASES])
def test_chunked_attention_matches_reference(ref, inp, i):
    kv, g, qc, kc, win = ATTN_CASES[i]
    q, k, v = (inp[f"attn{i}_{n}"] for n in "qkv")
    out = attn_mod.chunked_attention(q, k, v, window=win or None,
                                     q_chunk=qc, kv_chunk=kc)
    assert out.shape == q.shape
    _close(out, ref[f"attn{i}"], "attention")


def test_chunked_attention_matches_dense_softmax(inp):
    """The chunked online softmax equals one dense masked softmax."""
    q, k, v = (inp[f"attn1_{n}"] for n in "qkv")           # window 12
    out = attn_mod.chunked_attention(q, k, v, window=12, q_chunk=8,
                                     kv_chunk=16)
    s = torch.einsum("bqkgd,btkd->bkgqt", q, k) / DH ** 0.5
    pos = torch.arange(ATTN_S)
    diff = pos[:, None] - pos[None, :]
    s = s.masked_fill(~((diff >= 0) & (diff < 12)), float("-inf"))
    want = torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("i", range(len(DEC_LAYOUTS)),
                         ids=["kv{}g{}".format(*c) for c in DEC_LAYOUTS])
def test_decode_attention_matches_reference(ref, inp, i):
    q, k, v = (inp[f"dec{i}_{n}"] for n in "qkv")
    out = attn_mod.decode_attention(q, k, v, length=inp["dec_len"])
    _close(out, ref[f"dec{i}"], "decode attention")


def test_gqa_forward_matches_reference(ref, inp, models):
    cfg = _cfg(3)
    x = inp["gqa_x"]
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])
    y, _ = _windowed_prefill(models[3].groups[0].attn.attn, x, pos, cfg,
                             cfg.local_window)
    _close(y, ref["gqa"], "gqa")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CASES = [(n, s) for n in LAYERS for s in PROMPTS]


def _ids(c):
    return f"L{c[0]}S{c[1]}"


def _compare_cache(got, want_ref, cfg, what):
    want = cache_from_reference(want_ref, cfg)
    assert len(got["groups"]) == len(want["groups"])
    assert len(got["tail"]) == len(want["tail"])
    for g, w in zip(got["groups"], want["groups"]):
        for sub in ("rg1", "rg2"):
            for k in ("conv", "h"):
                _close(g[sub][k], w[sub][k].numpy(), f"{what} {sub}.{k}")
        for j, name in enumerate("kv"):
            _close(g["kv"][j], w["kv"][j].numpy(), f"{what} {name}")
    for g, w in zip(got["tail"], want["tail"]):
        for k in ("conv", "h"):
            _close(g[k], w[k].numpy(), f"{what} tail.{k}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_matches_reference(ref, models, inp, case):
    n_layers, s = case
    logits, aux = forward(models[n_layers], inp[f"S{s}_tokens"])
    _close(logits, ref[f"L{n_layers}S{s}/forward"], "logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_match_reference(ref, models, inp, case):
    n_layers, s = case
    pre = f"L{n_layers}S{s}/"
    model = models[n_layers]
    before = launch_count()
    logits, cache, length = prefill(model, inp[f"S{s}_tokens"], s + STEPS)
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
    assert launch_count() == before            # the CPU never launches


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_from_converted_reference_cache(ref, models, case):
    """A reference cache carried over by ``cache_from_reference``
    continues the port's decode like its own."""
    n_layers, s = case
    pre = f"L{n_layers}S{s}/"
    model = models[n_layers]
    cache = cache_from_reference(nest(ref, pre + "cache/"), model.cfg)
    logits, _ = decode_step(model, torch.as_tensor(ref[pre + "tok0"]),
                            cache, torch.as_tensor(ref[pre + "length"]))
    _close(logits, ref[pre + "step0"], "step 0 logits")


@pytest.mark.parametrize("n_layers", LAYERS)
def test_init_cache_shapes(n_layers):
    cfg = _cfg(n_layers)
    cache = init_cache(cfg, 3, 20, torch_device="cpu")
    assert len(cache["groups"]) == 1 and len(cache["tail"]) == n_layers - 3
    states = [st for g in cache["groups"] for st in (g["rg1"], g["rg2"])]
    for st in states + cache["tail"]:
        assert st["conv"].shape == (3, cfg.rg_conv_width - 1, 64)
        assert st["h"].shape == (3, 64) and st["h"].dtype == torch.float32
    for t in cache["groups"][0]["kv"]:
        assert t.shape == (3, 20, 1, 16)       # min(window 32, cache_len)
    assert init_cache(cfg, 1, 100, torch_device="cpu")["groups"][0]["kv"][0]\
        .shape[1] == cfg.local_window


def test_decode_from_zero_cache_equals_one_token_prefill(models):
    """A zero cache is the empty context: one decode step from it is a
    prefill of that one token."""
    model = models[5]
    token = torch.tensor([5, 77], dtype=torch.int32)
    cache = init_cache(model.cfg, 2, 8, torch_device="cpu")
    logits, _ = decode_step(model, token, cache,
                            torch.zeros(2, dtype=torch.int32))
    want, _, _ = prefill(model, token[:, None], 8)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_lm_params_cover_the_model_exactly(ref, models, n_layers):
    sd = lm_params_from_reference(nest(ref, f"L{n_layers}/p/"),
                                  _cfg(n_layers))
    assert set(sd) == set(models[n_layers].state_dict())
    for k, t in models[n_layers].state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    assert ("lm_head" in sd) is False          # tied: the head is embed.T


def test_lm_params_from_reference_rejects_wrong_group_axis(ref):
    tree = nest(ref, "L5/p/")
    tree["tail"]["block"]["w_in"] = tree["tail"]["block"]["w_in"][:1]
    with pytest.raises(ValueError, match="leading axis"):
        lm_params_from_reference(tree, _cfg(5))


@pytest.mark.cuda
def test_cuda_hybrid_matches_cpu():
    """The reduced 5-layer hybrid on the card (through the rglru kernel)
    against the same weights on the CPU: prefill of 48 tokens (beyond the
    window) and 8 teacher-forced decode steps, within 1e-4 of max |logit|
    (cuBLAS sums in other orders than the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cpu = init_model(_cfg(5), seed=5, torch_device="cpu")
    gpu = init_model(cpu.cfg, torch_device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(_inputs()["S48_tokens"])
    before = launch_count()
    lc, cc, nc = prefill(cpu, toks, 48 + STEPS)
    lg, cg, ng = prefill(gpu, toks.cuda(), 48 + STEPS)
    for i in range(STEPS + 1):
        scale = float(lc.abs().max())
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * scale, i
        if i == STEPS:
            break
        token = lc.argmax(-1).to(torch.int32)
        lc, cc = decode_step(cpu, token, cc, nc)
        lg, cg = decode_step(gpu, token.cuda(), cg, ng)
        nc, ng = nc + 1, ng + 1
    assert launch_count() == before + 4 * (STEPS + 1)   # 4 RG-LRU layers
