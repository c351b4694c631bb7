"""The RWKV-6 serving path as a whole: ``forward``, ``prefill`` and eight
``decode_step``s of the port against the reference's, with the
reference's ``init_model`` weights carried over by
``lm_params_from_reference`` and its stacked caches by
``cache_from_reference``, on the reduced config at one head
(d_model 64) and four heads (d_model 256); the cache's shapes; the
serve CLI on the CPU (RWKV-6, RecurrentGemma and the dense family in
float32 and bfloat16, whose model tests are in ``test_torch_hybrid.py``
and ``test_torch_dense.py``); the architecture registry; and the device
rule of the entry points.

Decoding is teacher-forced: both sides are fed the reference's greedy
tokens, so a near-tie cannot make the two runs diverge; the port's own
argmax must equal the reference's wherever the reference's top-2 gap
exceeds the tolerance. Tolerance: 2e-5 of the reference's max |logit|
(float32 on both sides, summation order only; measured ~2e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import hybrid_layout
from repro_torch.convert import cache_from_reference, lm_params_from_reference
from repro_torch.kernels.rglru import launch_count as rglru_launch_count
from repro_torch.kernels.wkv6 import launch_count
from repro_torch.launch import serve
from repro_torch.launch.steps import serve_step
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

RTOL = 2e-5
WIDTHS = (64, 256)
B, S, STEPS, CACHE_LEN = 2, 24, 8, 40


def _cfg(d):
    return dataclasses.replace(get_config("rwkv6-3b").reduced(), d_model=d)


def _tokens(d):
    return np.random.default_rng(d).integers(0, 128, (B, S)).astype(np.int32)


REF = FLAT + """
import dataclasses
import jax.numpy as jnp
from repro.configs import get_config
from repro.models.transformer import decode_step, forward, init_model, prefill
for d in inp["widths"]:
    d = int(d)
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), d_model=d)
    params = init_model(jax.random.PRNGKey(100 + d), cfg)
    out.update(flat(params, f"d{d}/p/"))
    toks = jnp.asarray(inp[f"d{d}_tokens"])
    out[f"d{d}/forward"] = forward(params, cfg, toks)[0]
    logits, cache, length = prefill(params, cfg, toks, int(inp["cache_len"]))
    out[f"d{d}/prefill"] = logits
    out[f"d{d}/length"] = length
    out.update(flat(cache, f"d{d}/cache/"))
    for i in range(int(inp["steps"])):
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode_step(params, cfg, token, cache, length)
        length = length + 1
        out[f"d{d}/tok{i}"], out[f"d{d}/step{i}"] = token, logits
    out.update(flat(cache, f"d{d}/cache_end/"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"widths": np.array(WIDTHS), "steps": np.array(STEPS),
              "cache_len": np.array(CACHE_LEN)}
    for d in WIDTHS:
        inputs[f"d{d}_tokens"] = _tokens(d)
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_serve"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for d in WIDTHS:
        model = init_model(_cfg(d), torch_device="cpu")
        model.load_state_dict(
            lm_params_from_reference(nest(ref, f"d{d}/p/"), _cfg(d)))
        out[d] = model
    return out


def _close(got, want, what):
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"
    return scale


def _same_argmax_where_clear(got, want):
    """Port and reference pick the same token wherever the reference's
    top-2 gap exceeds the tolerance."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > RTOL * np.abs(want).max()
    assert np.array_equal(got.argmax(-1).numpy()[clear],
                          want.argmax(-1)[clear])


@pytest.mark.parametrize("d", WIDTHS)
def test_forward_matches_reference(ref, models, d):
    logits, aux = forward(models[d], torch.as_tensor(_tokens(d)))
    _close(logits, ref[f"d{d}/forward"], "logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("d", WIDTHS)
def test_prefill_and_decode_match_reference(ref, models, d):
    model = models[d]
    before = launch_count()
    logits, cache, length = prefill(model, torch.as_tensor(_tokens(d)),
                                    CACHE_LEN)
    _close(logits, ref[f"d{d}/prefill"], "prefill logits")
    _same_argmax_where_clear(logits, ref[f"d{d}/prefill"])
    assert length.dtype == torch.int32
    np.testing.assert_array_equal(length.numpy(), ref[f"d{d}/length"])
    want = cache_from_reference(nest(ref, f"d{d}/cache/"), model.cfg)
    for got_l, want_l in zip(cache, want):
        for k in ("tm_x", "wkv", "cm_x"):
            _close(got_l[k], want_l[k].numpy(), f"prefill cache {k}")
    for i in range(STEPS):
        token = torch.as_tensor(ref[f"d{d}/tok{i}"])
        logits, cache = decode_step(model, token, cache, length)
        length = length + 1
        _close(logits, ref[f"d{d}/step{i}"], f"step {i} logits")
        _same_argmax_where_clear(logits, ref[f"d{d}/step{i}"])
    want = cache_from_reference(nest(ref, f"d{d}/cache_end/"), model.cfg)
    for got_l, want_l in zip(cache, want):
        _close(got_l["wkv"], want_l["wkv"].numpy(), "final wkv state")
    assert launch_count() == before            # the CPU never launches


@pytest.mark.parametrize("d", WIDTHS)
def test_decode_from_converted_reference_cache(ref, models, d):
    """A reference cache carried over by ``cache_from_reference``
    continues the port's decode like its own."""
    model = models[d]
    cache = cache_from_reference(nest(ref, f"d{d}/cache/"), model.cfg)
    length = torch.as_tensor(ref[f"d{d}/length"])
    logits, _ = decode_step(model, torch.as_tensor(ref[f"d{d}/tok0"]),
                            cache, length)
    _close(logits, ref[f"d{d}/step0"], "step 0 logits")


@pytest.mark.parametrize("d", WIDTHS)
def test_init_cache_shapes(d):
    cfg = _cfg(d)
    cache = init_cache(cfg, 3, CACHE_LEN, torch_device="cpu")
    h = rwkv_mod.n_heads(cfg)
    assert len(cache) == cfg.n_layers
    for st in cache:
        assert st["wkv"].shape == (3, h, 64, 64)
        assert st["wkv"].dtype == torch.float32
        assert st["tm_x"].shape == st["cm_x"].shape == (3, d)
        assert not any(bool(t.any()) for t in st.values())


def test_decode_from_zero_cache_equals_one_token_prefill(models):
    """A zero cache is the empty context: one decode step from it is a
    prefill of that one token."""
    model = models[256]
    token = torch.tensor([5, 77], dtype=torch.int32)
    cache = init_cache(model.cfg, 2, 8, torch_device="cpu")
    logits, _ = decode_step(model, token, cache, torch.zeros(2, dtype=torch.int32))
    want, _, _ = prefill(model, token[:, None], 8)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)


def test_serve_step_is_greedy_with_first_index_ties(models):
    model = init_model(_cfg(64), torch_device="cpu")
    model.load_state_dict(models[64].state_dict())
    with torch.no_grad():
        model.lm_head.zero_()                  # every logit ties at 0
    cache = init_cache(model.cfg, 2, 8, torch_device="cpu")
    length = torch.zeros(2, dtype=torch.int32)
    nxt, logits, cache, length2 = serve_step(
        model, cache, torch.tensor([3, 4], dtype=torch.int32), length)
    assert nxt.dtype == torch.int32 and nxt.tolist() == [0, 0]
    assert logits.shape == (2, model.cfg.vocab)
    assert length2.tolist() == [1, 1]


def test_serve_cli_on_cpu(capsys):
    rc = serve.main(["--arch", "rwkv6-3b", "--device", "cpu", "--reduced",
                     "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "prefill 2x8" in out and "decode latency p50" in out
    assert "sample row 0" in out


def test_generate_counts_steps_and_tokens(models):
    before = launch_count()
    prompts = serve.make_prompts(128, 2, 6, seed=1, device="cpu")
    assert prompts.dtype == torch.int32 and prompts.shape == (2, 6)
    res = serve.generate(models[64], prompts, gen=5)
    assert res["tokens"].shape == (2, 5) and len(res["decode_ms"]) == 4
    assert res["all_finite"]
    assert launch_count() == before


def test_get_config_registry():
    assert ARCH_NAMES == ("smollm-135m", "qwen2.5-14b", "qwen3-8b", "yi-6b",
                          "recurrentgemma-9b", "rwkv6-3b", "deepseek-v2-236b",
                          "llama4-maverick-400b-a17b", "internvl2-26b",
                          "hubert-xlarge")
    cfg = get_config("rwkv6-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (32, 2560, 8960, 65536)
    assert rwkv_mod.n_heads(cfg) == 40
    assert cfg.param_count() == 3_099_443_200
    assert cfg.sub_quadratic and get_config("recurrentgemma-9b").sub_quadratic
    qwen3 = get_config("qwen3-8b")
    assert (qwen3.family, qwen3.n_layers, qwen3.d_model, qwen3.qk_norm,
            qwen3.qkv_bias) == ("dense", 36, 4096, True, False)
    assert not qwen3.sub_quadratic
    assert [get_config(name).family
            for name in ("internvl2-26b", "hubert-xlarge")] == ["vlm", "audio"]
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_recurrentgemma_config():
    """The full-width hybrid: 12 groups of (rglru, rglru, local) and a
    2-layer tail; ``param_count`` is the reference's pattern-weighted
    estimate (the model's exact ``numel`` is 8,578,519,040)."""
    cfg = get_config("recurrentgemma-9b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        ("hybrid", 38, 4096, 12288, 256000)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_head) == (16, 1, 256)
    assert (cfg.local_window, cfg.rg_lru_width, cfg.rg_conv_width) == \
        (2048, 4096, 4)
    assert cfg.tie_embeddings and hybrid_layout(cfg) == (12, 2)
    assert cfg.param_count() == 8_513_454_080
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.d_head, small.local_window,
            small.rg_lru_width, small.n_kv_heads) == (3, 64, 16, 32, 64, 1)
    assert get_config("rwkv6-3b").reduced().n_layers == 2


def test_serve_cli_on_cpu_recurrentgemma(capsys):
    before = rglru_launch_count()
    rc = serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                     "--reduced", "--batch", "2", "--prompt-len", "40",
                     "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "recurrentgemma-9b-smoke on cpu: prefill 2x40" in out
    assert "decode latency p50" in out and "sample row 0" in out
    assert rglru_launch_count() == before


@pytest.mark.parametrize("dtype,arch", [
    ("float32", None), ("bfloat16", "qwen2.5-14b")])
def test_serve_cli_on_cpu_dense(capsys, dtype, arch):
    """The CLI's default arch is the JAX package CLI's, ``smollm-135m``;
    ``--dtype bfloat16`` serves bf16 weights and caches."""
    argv = ["--device", "cpu", "--reduced", "--batch", "2",
            "--prompt-len", "12", "--gen", "4", "--dtype", dtype]
    if arch:
        argv += ["--arch", arch]
    before = launch_count(), rglru_launch_count()
    rc = serve.main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    name = f"{arch or 'smollm-135m'}-smoke"
    assert f"{name}: " in out and f"torch.{dtype}" in out
    assert f"{name} on cpu: prefill 2x12" in out
    assert "decode latency p50" in out and "sample row 0" in out
    assert (launch_count(), rglru_launch_count()) == before


def test_hybrid_entry_points_need_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = get_config("recurrentgemma-9b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "recurrentgemma-9b", "--reduced", "--batch",
                    "1", "--prompt-len", "2", "--gen", "1"])
    assert isinstance(init_cache(cfg, 1, 8, torch_device="cpu"), dict)


def test_other_families_raise():
    cfg = dataclasses.replace(_cfg(64), family="retrieval")
    with pytest.raises(NotImplementedError):
        init_model(cfg, torch_device="cpu")
    with pytest.raises(NotImplementedError):
        init_cache(cfg, 1, 8, torch_device="cpu")


def test_entry_points_need_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = _cfg(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "2",
                    "--gen", "1"])


@pytest.mark.cuda
def test_cuda_model_matches_cpu():
    """The 4-head reduced model on the card (through the wkv6 kernel)
    against the same weights on the CPU: prefill and 8 teacher-forced
    decode steps, within 1e-4 of max |logit| (cuBLAS and the kernel sum
    in other orders than the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cpu = init_model(_cfg(256), seed=5, torch_device="cpu")
    gpu = init_model(cpu.cfg, torch_device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(_tokens(256))
    before = launch_count()
    lc, cc, nc = prefill(cpu, toks, CACHE_LEN)
    lg, cg, ng = prefill(gpu, toks.cuda(), CACHE_LEN)
    for i in range(STEPS + 1):
        scale = float(lc.abs().max())
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * scale, i
        if i == STEPS:
            break
        token = lc.argmax(-1).to(torch.int32)
        lc, cc = decode_step(cpu, token, cc, nc)
        lg, cg = decode_step(gpu, token.cuda(), cg, ng)
    assert launch_count() == before + cpu.cfg.n_layers * (STEPS + 1)
