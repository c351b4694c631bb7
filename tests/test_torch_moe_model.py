"""The moe family as a whole model: the reduced ``deepseek-v2-236b`` (a
leading dense layer of MLA and a 128-wide MLP, then a MoE layer of MLA,
one shared and 8 routed experts, top-2) and the reduced
``llama4-maverick-400b-a17b`` (one group: a GQA dense layer, then a GQA
MoE layer of one shared and 8 routed experts, top-1), d_model 64,
vocabulary 128, against the reference's.

The reference's ``init_model`` draws the weights, then every norm weight
(``ln1``, ``ln2``, ``final_norm``, ``q_norm``, ``kv_norm``; the
reference inits them to one) is drawn with numpy from a seed in its
tree; ``lm_params_from_reference`` carries the whole tree over and
``cache_from_reference`` the caches.

- ``forward`` (logits and the summed load-balancing loss; the experts
  run with the capacity drops), ``prefill`` (logits and cache: the
  latent pairs of deepseek, the K/V pairs of llama4's two layers) and
  four teacher-forced ``decode_step``s (the experts exact), and a decode
  continued from a converted reference cache.
- ``param_count`` and ``active_param_count`` of both full configs and of
  the depth cuts the card serves (8 and 2 layers), equal to the
  reference's; ``applicable`` for both names.
- R10: a moe config with ``moe_every == 1`` and no MLA, which the
  reference builds but cannot prefill (``KeyError``), is refused.

Tolerance: 2e-5 of the reference output's max |value| in float32 (both
sides compute in float32 and differ by summation order; measured on the
CPU: at most 1.5e-6); the greedy tokens equal wherever the reference's
top-2 gap exceeds that.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import SHAPES, applicable, get_config
from repro_torch.convert import cache_from_reference, lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_model,
    prefill,
)

RTOL = 2e-5
SUBJECTS = {"deepseek": "deepseek-v2-236b",
            "llama4": "llama4-maverick-400b-a17b"}
TAGS = list(SUBJECTS)
CUTS = {"deepseek-v2-236b": 8, "llama4-maverick-400b-a17b": 2}
B, S, STEPS = 2, 24, 4


def _cfg(tag):
    return get_config(SUBJECTS[tag]).reduced()


def _inputs():
    rng = np.random.default_rng(41)
    inp = {"tags": np.array(TAGS), "names": np.array(list(SUBJECTS.values())),
           "cut_layers": np.array(list(CUTS.values())),
           "steps": np.array(STEPS), "norm_seed": np.array(43)}
    for tag in TAGS:
        inp[f"{tag}_tokens"] = rng.integers(0, _cfg(tag).vocab,
                                            (B, S)).astype(np.int32)
    return inp


REF = FLAT + """
import dataclasses
import jax.numpy as jnp
from repro.configs import SHAPES, applicable, get_config
from repro.models.transformer import (decode_step, forward, init_model,
                                      prefill)

J = jnp.asarray
f32 = lambda a: np.asarray(a, np.float32)
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm")
rng = np.random.default_rng(int(inp["norm_seed"]))


def renorm(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            renorm(tree[k])
        elif k in NORMS:
            draw = 1.0 + 0.2 * rng.standard_normal(tree[k].shape)
            tree[k] = J(draw.astype(np.float32))


def save_cache(cache, pre):
    for key, (a, b) in cache.items():
        out[f"{pre}{key}/a"], out[f"{pre}{key}/b"] = f32(a), f32(b)


for name, cut in zip(inp["names"], inp["cut_layers"]):
    name = str(name)
    for tag, cfg in (("full", get_config(name)),
                     ("cut", dataclasses.replace(get_config(name),
                                                 n_layers=int(cut)))):
        out[f"count/{tag}/{name}"] = np.array(cfg.param_count())
        out[f"active/{tag}/{name}"] = np.array(cfg.active_param_count())
    for c in SHAPES:
        ok, why = applicable(get_config(name), c)
        out[f"applicable/{name}/{c.name}"] = np.array([str(ok), why])
r10 = dataclasses.replace(get_config("llama4-maverick-400b-a17b").reduced(),
                          moe_every=1)
try:
    prefill(init_model(jax.random.PRNGKey(0), r10), r10,
            jnp.zeros((1, 4), jnp.int32), 8)
    out["r10"] = np.array("ok")
except Exception as e:
    out["r10"] = np.array(type(e).__name__)

jf = jax.jit(forward, static_argnums=(1,))
jp = jax.jit(prefill, static_argnums=(1, 3))
jd = jax.jit(decode_step, static_argnums=(1,))
steps = int(inp["steps"])
for i, (tag, name) in enumerate(zip(inp["tags"], inp["names"])):
    tag, cfg = str(tag), get_config(str(name)).reduced()
    params = init_model(jax.random.PRNGKey(60 + i), cfg)
    renorm(params)
    out.update(flat(params, tag + "/p/"))
    toks = J(inp[tag + "_tokens"])
    logits, aux = jf(params, cfg, toks)
    out[tag + "/forward"], out[tag + "/aux"] = f32(logits), f32(aux)
    logits, cache, length = jp(params, cfg, toks, toks.shape[1] + steps)
    out[tag + "/prefill"], out[tag + "/length"] = f32(logits), length
    save_cache(cache, tag + "/cache/")
    for j in range(steps):
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = jd(params, cfg, token, cache, length)
        length = length + 1
        out[tag + f"/tok{j}"], out[tag + f"/step{j}"] = token, f32(logits)
    save_cache(cache, tag + "/cache_end/")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, _inputs(),
                         tmp_path_factory.mktemp("ref_moe_model"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for tag in TAGS:
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
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > rtol * np.abs(want).max()
    assert np.array_equal(got.float().argmax(-1).numpy()[clear],
                          want.argmax(-1)[clear])


def _ref_cache(ref, pre):
    """The reference's cache pytree, its (a, b) pairs rebuilt."""
    return {key: (pair["a"], pair["b"]) for key, pair in nest(ref, pre).items()}


def _compare_cache(got, ref, pre, cfg, what):
    want = cache_from_reference(_ref_cache(ref, pre), cfg)
    assert set(got) == set(want), (set(got), set(want))
    for key in want:
        assert len(got[key]) == len(want[key])
        for (ga, gb), (wa, wb) in zip(got[key], want[key]):
            _close(ga, wa.numpy(), f"{what} {key}")
            _close(gb, wb.numpy(), f"{what} {key}")


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", ["full", "cut"])
@pytest.mark.parametrize("name", list(CUTS))
def test_param_counts_match_reference(ref, name, depth):
    cfg = get_config(name)
    if depth == "cut":
        cfg = dataclasses.replace(cfg, n_layers=CUTS[name])
    assert cfg.family == "moe" and cfg.moe
    assert cfg.param_count() == int(ref[f"count/{depth}/{name}"])
    assert cfg.active_param_count() == int(ref[f"active/{depth}/{name}"])


def test_depth_cuts_fit_one_card():
    """The cuts the card serves keep every width and all the experts:
    deepseek's leading dense layer and 7 MoE layers, llama4's one group."""
    ds = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=8)
    ll = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                             n_layers=2)
    assert ds.param_count() == 29_191_274_496 and ds.moe_layout() == (7, 1)
    assert ll.param_count() == 18_553_241_600 and ll.moe_layout() == (1, 1)
    for cfg in (get_config("deepseek-v2-236b"),
                get_config("llama4-maverick-400b-a17b")):
        assert 2 * cfg.param_count() > 80e9             # bf16, full depth


@pytest.mark.parametrize("name", list(CUTS))
def test_applicability_matches_reference(ref, name):
    for c in SHAPES:
        ok, why = applicable(get_config(name), c)
        assert [str(ok), why] == ref[f"applicable/{name}/{c.name}"].tolist()


def test_r10_combination_is_refused(ref):
    """The reference builds ``moe_layers`` for a non-MLA moe config with
    ``moe_every == 1`` but its prefill reads ``layers``; the port
    refuses the config at every entry point."""
    assert str(ref["r10"]) == "KeyError"
    cfg = dataclasses.replace(_cfg("llama4"), moe_every=1)
    with pytest.raises(ValueError, match="R10"):
        init_model(cfg, torch_device="cpu")
    with pytest.raises(ValueError, match="R10"):
        init_cache(cfg, 1, 8, torch_device="cpu")


@pytest.mark.parametrize("tag", TAGS)
def test_lm_params_cover_the_model_exactly(ref, models, tag):
    sd = lm_params_from_reference(nest(ref, f"{tag}/p/"), _cfg(tag))
    assert set(sd) == set(models[tag].state_dict())
    for k, t in models[tag].state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    assert not torch.all(models[tag].final_norm == 1)
    extra = dict(sd, **{"final_norm2": sd["final_norm"]})
    with pytest.raises(RuntimeError, match="Unexpected"):
        models[tag].load_state_dict(extra)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_forward_matches_reference(ref, models, inp, tag):
    logits, aux = forward(models[tag], inp[f"{tag}_tokens"])
    _close(logits, ref[f"{tag}/forward"], "logits")
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(ref[f"{tag}/aux"])) <= \
        RTOL * float(ref[f"{tag}/aux"])


@pytest.mark.parametrize("tag", TAGS)
def test_prefill_and_decode_match_reference(ref, models, inp, tag):
    model, pre = models[tag], f"{tag}/"
    logits, cache, length = prefill(model, inp[f"{tag}_tokens"], S + STEPS)
    _close(logits, ref[pre + "prefill"], "prefill logits")
    _same_argmax_where_clear(logits, ref[pre + "prefill"])
    np.testing.assert_array_equal(length.numpy(), ref[pre + "length"])
    _compare_cache(cache, ref, pre + "cache/", model.cfg, "prefill")
    for i in range(STEPS):
        token = torch.as_tensor(ref[pre + f"tok{i}"])
        logits, cache = decode_step(model, token, cache, length)
        length = length + 1
        _close(logits, ref[pre + f"step{i}"], f"step {i} logits")
        _same_argmax_where_clear(logits, ref[pre + f"step{i}"])
    _compare_cache(cache, ref, pre + "cache_end/", model.cfg, "end")


@pytest.mark.parametrize("tag", TAGS)
def test_decode_from_converted_reference_cache(ref, models, tag):
    model, pre = models[tag], f"{tag}/"
    cache = cache_from_reference(_ref_cache(ref, pre + "cache/"), model.cfg)
    logits, _ = decode_step(model, torch.as_tensor(ref[pre + "tok0"]),
                            cache, torch.as_tensor(ref[pre + "length"]))
    _close(logits, ref[pre + "step0"], "step 0 logits")


@pytest.mark.parametrize("tag", TAGS)
def test_init_cache_matches_prefill_layout(models, inp, tag):
    cfg = _cfg(tag)
    cache = init_cache(cfg, B, S + 2, torch_device="cpu")
    _, got, _ = prefill(models[tag], inp[f"{tag}_tokens"], S + 2)
    assert set(cache) == set(got)
    for key in cache:
        assert [tuple(t.shape) for pair in cache[key] for t in pair] == \
            [tuple(t.shape) for pair in got[key] for t in pair]
        assert not any(t.any() for pair in cache[key] for t in pair)


@pytest.mark.parametrize("arch", list(CUTS))
def test_serve_cli_on_cpu_moe(capsys, arch):
    rc = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                     "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"{arch}-smoke on cpu: prefill 2x12" in out
    assert "decode latency p50" in out and "sample row 0" in out


def test_full_depth_configs_exceed_one_card():
    """``serve`` refuses, before drawing a weight, a config whose weights
    exceed the card's free memory, naming both byte counts."""
    from repro_torch.models.common import DTypePolicy

    cfg = get_config("llama4-maverick-400b-a17b")
    with pytest.raises(RuntimeError, match="795415357440 bytes") as exc:
        serve.require_fits(cfg, DTypePolicy.bf16(), 80 * 10**9)
    assert "80000000000 free" in str(exc.value)
    cut = dataclasses.replace(cfg, n_layers=2)
    assert serve.weight_bytes(cut, DTypePolicy.bf16()) == 37_107_845_120
    serve.require_fits(cut, DTypePolicy.bf16(), 80 * 10**9)


def test_moe_entry_points_need_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = _cfg("deepseek")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "deepseek-v2-236b", "--reduced", "--batch",
                    "1", "--prompt-len", "2", "--gen", "1"])


@pytest.mark.cuda
def test_cuda_moe_matches_cpu():
    """Both reduced configs widened to d_model 256 on the card against
    the same weights on the CPU: prefill of 24 tokens and 4
    teacher-forced decode steps within 1e-4 of max |logit| (cuBLAS sums
    in other orders than the CPU), and ``forward``'s capacity drops
    (the same routed pairs on both devices at these seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for tag in TAGS:
        cfg = dataclasses.replace(_cfg(tag), d_model=256, d_head=64)
        cpu = init_model(cfg, seed=5, torch_device="cpu")
        gpu = init_model(cfg, torch_device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        toks = torch.as_tensor(_inputs()[f"{tag}_tokens"])
        fc, ac = forward(cpu, toks)
        fg, ag = forward(gpu, toks.cuda())
        assert float((fg.cpu() - fc).abs().max()) <= 1e-4 * float(
            fc.abs().max())
        assert abs(float(ag) - float(ac)) <= 1e-5 * float(ac)
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
