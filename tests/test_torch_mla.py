"""Multi-head latent attention (DeepSeek-V2's MLA): the port's layer
against the reference's on the reduced ``deepseek-v2-236b`` (d_model 64,
4 heads, q rank 24, kv rank 16, nope/rope/v head widths 16/8/16).

The reference's ``init_mla`` draws the projections; it inits the latent
norm weights (``q_norm``, ``kv_norm``) to one, so they are drawn with
numpy from a seed and put into the reference's tree before it computes.

- ``_mla_qkv``: the four outputs (q_nope, q_rope and k_rope after RoPE,
  the normed latent).
- ``mla_forward`` at S = 37 with small chunks (8/16), so the causal
  chunk skipping and the padding of the last chunk run.
- ``mla_prefill``: the output and the latent cache right-padded to
  S + 5.
- ``mla_decode`` (the absorbed path) from a random latent cache with
  per-row lengths that differ (1, 13, 19 of 20): output and both whole
  caches after the per-row write.

Each in float32 and in bfloat16 (weights, input and cache rounded to
bf16 on both sides). Tolerance: 2e-5 of the reference output's max
|value| in float32 (summation order only; measured on the CPU: at most
4.7e-7). In bfloat16: 2e-2 of max |value|, the dense family's bound: the
two sides may round their 16-bit products at different points (the
reference's full-sequence products are XLA bf16 dots, the port's widen
to float32; the absorbed decode rounds each einsum to bf16 on both
sides), and one bf16 rounding moves a value by up to 2^-8 of itself.
Measured on the CPU at these widths: 0, every bf16 output bit-equal.
"""
import numpy as np
import pytest
import torch

from test_torch_support import nest, run_reference

from repro_torch.configs import get_config
from repro_torch.models import attention as attn_mod

RTOL = 2e-5
BF16_RTOL = 2e-2
ATT_S, DEC_T = 37, 20
DEC_LEN = (1, 13, 19)
DTYPES = ("f32", "bf16")


def _cfg():
    return get_config("deepseek-v2-236b").reduced()


def _inputs():
    rng = np.random.default_rng(31)
    cfg = _cfg()

    def n(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"q_norm": n(cfg.q_lora_rank, scale=0.3, shift=1.0),
            "kv_norm": n(cfg.kv_lora_rank, scale=0.3, shift=1.0),
            "x": n(2, ATT_S, cfg.d_model), "x1": n(3, 1, cfg.d_model),
            "c": n(3, DEC_T, cfg.kv_lora_rank),
            "r": n(3, DEC_T, cfg.qk_rope_head_dim),
            "dec_len": np.array(DEC_LEN, dtype=np.int32)}


REF = """
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import attention as attn

J = jnp.asarray
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
cfg = get_config("deepseek-v2-236b").reduced()
p = attn.init_mla(jax.random.PRNGKey(3), cfg, attn.DTypePolicy())
p["q_norm"], p["kv_norm"] = J(inp["q_norm"]), J(inp["kv_norm"])
for k, v in p.items():
    out["p/" + k] = v
for dt, cast in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    pp = {k: v.astype(cast) for k, v in p.items()}
    x = J(inp["x"]).astype(cast)
    pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
    for name, a in zip(("q_nope", "q_rope", "ckv", "k_rope"),
                       attn._mla_qkv(pp, x, pos, cfg)):
        out[f"{dt}/{name}"] = f32(a)
    out[dt + "/forward"] = f32(attn.mla_forward(pp, x, pos, cfg, q_chunk=8,
                                                kv_chunk=16))
    y, (c1, c2) = attn.mla_prefill(pp, x, pos, cfg, x.shape[1] + 5,
                                   q_chunk=8, kv_chunk=16)
    out[dt + "/prefill_y"], out[dt + "/prefill_c"] = f32(y), f32(c1)
    out[dt + "/prefill_r"] = f32(c2)
    y, (c1, c2) = attn.mla_decode(
        pp, J(inp["x1"]).astype(cast),
        (J(inp["c"]).astype(cast), J(inp["r"]).astype(cast)),
        J(inp["dec_len"]), cfg)
    out[dt + "/decode_y"], out[dt + "/decode_c"] = f32(y), f32(c1)
    out[dt + "/decode_r"] = f32(c2)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REF, _inputs(), tmp_path_factory.mktemp("ref_mla"))


@pytest.fixture(scope="module")
def inp():
    return {k: torch.as_tensor(v) for k, v in _inputs().items()}


def _dtype(dt):
    return torch.float32 if dt == "f32" else torch.bfloat16


@pytest.fixture(scope="module")
def layers(ref):
    out = {}
    for dt in DTYPES:
        layer = attn_mod.MLA(_cfg(), device="cpu")
        layer.load_state_dict({k: torch.as_tensor(v)
                               for k, v in nest(ref, "p/").items()})
        out[dt] = layer.to(_dtype(dt))
    return out


def _close(got, want, what, dt):
    rtol = RTOL if dt == "f32" else BF16_RTOL
    assert got.dtype == _dtype(dt), (what, got.dtype)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


def _x(inp, dt):
    x = inp["x"].to(_dtype(dt))
    return x, torch.arange(x.shape[1]).expand(x.shape[:2])


def test_norm_weights_are_not_the_defaults(layers):
    assert not torch.all(layers["f32"].q_norm == 1)
    assert not torch.all(layers["f32"].kv_norm == 1)


def test_init_mla_shapes():
    cfg = _cfg()
    p = attn_mod.init_mla(cfg, attn_mod.DTypePolicy(),
                          torch.Generator().manual_seed(0), "cpu")
    h, dn, dr, dv = 4, 16, 8, 16
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_dq": (64, 24), "w_uq": (24, h * (dn + dr)), "w_dkv": (64, 16 + dr),
        "w_uk": (16, h * dn), "w_uv": (16, h * dv), "wo": (h * dv, 64),
        "kv_norm": (16,), "q_norm": (24,)}
    assert (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == \
        (dn, dr, dv)


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_qkv_matches_reference(ref, layers, inp, dt):
    x, pos = _x(inp, dt)
    for got, name in zip(attn_mod._mla_qkv(layers[dt], x, pos, _cfg()),
                         ("q_nope", "q_rope", "ckv", "k_rope")):
        _close(got, ref[f"{dt}/{name}"], name, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_forward_matches_reference(ref, layers, inp, dt):
    x, pos = _x(inp, dt)
    y = attn_mod.mla_forward(layers[dt], x, pos, _cfg(), q_chunk=8,
                             kv_chunk=16)
    _close(y, ref[f"{dt}/forward"], "forward", dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_prefill_matches_reference(ref, layers, inp, dt):
    x, pos = _x(inp, dt)
    y, (c, r) = attn_mod.mla_prefill(layers[dt], x, pos, _cfg(), ATT_S + 5,
                                     q_chunk=8, kv_chunk=16)
    _close(y, ref[f"{dt}/prefill_y"], "y", dt)
    _close(c, ref[f"{dt}/prefill_c"], "latent", dt)
    _close(r, ref[f"{dt}/prefill_r"], "rope key", dt)
    assert not c[:, ATT_S:].any() and not r[:, ATT_S:].any()
    assert torch.equal(y, attn_mod.mla_forward(layers[dt], x, pos, _cfg(),
                                               q_chunk=8, kv_chunk=16))


@pytest.mark.parametrize("dt", DTYPES)
def test_mla_decode_writes_each_row_at_its_length(ref, layers, inp, dt):
    c0, r0 = inp["c"].to(_dtype(dt)), inp["r"].to(_dtype(dt))
    c, r = c0.clone(), r0.clone()
    y, (nc, nr) = attn_mod.mla_decode(layers[dt], inp["x1"].to(_dtype(dt)),
                                      (c, r), inp["dec_len"], _cfg())
    _close(y, ref[f"{dt}/decode_y"], "y", dt)
    _close(nc, ref[f"{dt}/decode_c"], "latent cache", dt)
    _close(nr, ref[f"{dt}/decode_r"], "rope cache", dt)
    assert nc.data_ptr() == c.data_ptr() and nr.data_ptr() == r.data_ptr()
    for row, n in enumerate(DEC_LEN):                 # one row each, at n
        keep = torch.ones(DEC_T, dtype=torch.bool)
        keep[n] = False
        assert torch.equal(nc[row, keep], c0[row, keep])
        assert torch.equal(nr[row, keep], r0[row, keep])
        assert not torch.equal(nc[row, n], c0[row, n])


def test_mla_decode_equals_the_full_sequence_pass(layers, inp):
    """The absorbed decode over a prefilled latent cache gives the last
    row of the materialised full-sequence pass (float32)."""
    cfg, layer = _cfg(), layers["f32"]
    x, pos = _x(inp, "f32")
    full = attn_mod.mla_forward(layer, x, pos, cfg, q_chunk=8, kv_chunk=16)
    _, cache = attn_mod.mla_prefill(layer, x[:, :-1], pos[:, :-1], cfg,
                                    ATT_S, q_chunk=8, kv_chunk=16)
    y, _ = attn_mod.mla_decode(layer, x[:, -1:], cache,
                               torch.full((2,), ATT_S - 1), cfg)
    torch.testing.assert_close(y, full[:, -1:], rtol=0,
                               atol=1e-5 * float(full.abs().max()))
