"""RWKV-6 blocks: the port's time mix, channel mix and whole layer
(``_rwkv_block``) against the reference's, with the reference's
``init_model`` weights carried over by ``lm_params_from_reference``, on
the reduced config at one head (d_model 64) and at four heads
(d_model 256, where a wrong head layout would show), from a zero state
and from a carried decode state.

Tolerance: 2e-5 of the reference output's max |value|. Both sides
compute in float32 and differ by summation order in the matrix products
and the recurrence; measured ~2e-6 on the whole model.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.transformer import _rwkv_block, init_model

RTOL = 2e-5
WIDTHS = (64, 256)                     # 1 and 4 heads of 64
B, S = 2, 12


def _cfg(d):
    return dataclasses.replace(get_config("rwkv6-3b").reduced(), d_model=d)


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    h = d // rwkv_mod.HEAD_DIM
    return dict(
        x=rng.standard_normal((B, S, d)).astype(np.float32),
        last_tm=rng.standard_normal((B, d)).astype(np.float32),
        last_cm=rng.standard_normal((B, d)).astype(np.float32),
        wkv=rng.standard_normal((B, h, 64, 64)).astype(np.float32))


REF = FLAT + """
import dataclasses
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import rwkv6
from repro.models.transformer import _rwkv_block, init_model
for d in inp["widths"]:
    d = int(d)
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), d_model=d)
    params = init_model(jax.random.PRNGKey(d), cfg)
    out.update(flat(params, f"d{d}/p/"))
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    x, lt, lc, wkv = (jnp.asarray(inp[f"d{d}_{n}"]) for n in
                      ("x", "last_tm", "last_cm", "wkv"))
    for tag, st in (("zero", None), ("carry", (lt, wkv))):
        y, (tx, s) = rwkv6.time_mix_forward(lp["tm"], x, cfg, st)
        out[f"d{d}/tm_{tag}/y"], out[f"d{d}/tm_{tag}/x"] = y, tx
        out[f"d{d}/tm_{tag}/s"] = s
    for tag, st in (("zero", None), ("carry", lc)):
        y, cx = rwkv6.channel_mix_forward(lp["cm"], x, st)
        out[f"d{d}/cm_{tag}/y"], out[f"d{d}/cm_{tag}/x"] = y, cx
    for tag, st in (("zero", None),
                    ("carry", {"tm_x": lt, "wkv": wkv, "cm_x": lc})):
        y, new = _rwkv_block(lp, x, cfg, st)
        out[f"d{d}/blk_{tag}/y"] = y
        out.update(flat(new, f"d{d}/blk_{tag}/"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"widths": np.array(WIDTHS)}
    for d in WIDTHS:
        for n, a in _inputs(d, seed=d).items():
            inputs[f"d{d}_{n}"] = a
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_rwkv6"))


@pytest.fixture(scope="module")
def models(ref):
    out = {}
    for d in WIDTHS:
        cfg = _cfg(d)
        model = init_model(cfg, torch_device="cpu")
        model.load_state_dict(
            lm_params_from_reference(nest(ref, f"d{d}/p/"), cfg))
        out[d] = model
    return out


def _close(got, want, what):
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


def _state(d, tag):
    c = {k: torch.as_tensor(v) for k, v in _inputs(d, seed=d).items()}
    return c, tag == "carry"


@pytest.mark.parametrize("tag", ["zero", "carry"])
@pytest.mark.parametrize("d", WIDTHS)
def test_time_mix_matches_reference(ref, models, d, tag):
    c, carry = _state(d, tag)
    tm = models[d].layers[0].tm
    st = (c["last_tm"], c["wkv"].clone()) if carry else None
    y, (tx, s) = rwkv_mod.time_mix_forward(tm, c["x"], _cfg(d), st)
    _close(y, ref[f"d{d}/tm_{tag}/y"], "y")
    _close(tx, ref[f"d{d}/tm_{tag}/x"], "last_x")
    _close(s, ref[f"d{d}/tm_{tag}/s"], "wkv state")
    y2, _ = tm(c["x"], (c["last_tm"], c["wkv"].clone()) if carry else None)
    assert torch.equal(y, y2)                  # the module is the function


@pytest.mark.parametrize("tag", ["zero", "carry"])
@pytest.mark.parametrize("d", WIDTHS)
def test_channel_mix_matches_reference(ref, models, d, tag):
    c, carry = _state(d, tag)
    cm = models[d].layers[0].cm
    st = c["last_cm"] if carry else None
    y, cx = rwkv_mod.channel_mix_forward(cm, c["x"], st)
    _close(y, ref[f"d{d}/cm_{tag}/y"], "y")
    _close(cx, ref[f"d{d}/cm_{tag}/x"], "last_x")
    assert torch.equal(cm(c["x"], st)[0], y)


@pytest.mark.parametrize("tag", ["zero", "carry"])
@pytest.mark.parametrize("d", WIDTHS)
def test_rwkv_block_matches_reference(ref, models, d, tag):
    c, carry = _state(d, tag)
    st = ({"tm_x": c["last_tm"], "wkv": c["wkv"].clone(),
           "cm_x": c["last_cm"]} if carry else None)
    y, new = _rwkv_block(models[d].layers[0], c["x"], _cfg(d), st)
    _close(y, ref[f"d{d}/blk_{tag}/y"], "y")
    for k in ("tm_x", "wkv", "cm_x"):
        _close(new[k], ref[f"d{d}/blk_{tag}/{k}"], k)


def test_shift_puts_zeros_or_carry_first():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    z = rwkv_mod._shift(x)
    assert torch.equal(z[:, 0], torch.zeros(2, 4))
    assert torch.equal(z[:, 1:], x[:, :-1])
    last = torch.full((2, 4), 7.0)
    assert torch.equal(rwkv_mod._shift(x, last)[:, 0], last)


def test_decay_is_float32_in_unit_interval():
    """Even under bf16 parameters the decay comes out in float32."""
    from repro_torch.models.common import DTypePolicy

    gen = torch.Generator().manual_seed(0)
    tm = rwkv_mod.TimeMix(_cfg(256), DTypePolicy(torch.bfloat16,
                                                 torch.bfloat16), gen)
    xw = torch.randn(2, 5, 256, generator=gen).to(torch.bfloat16)
    w = rwkv_mod._decay(tm, xw)
    assert w.dtype == torch.float32
    assert bool(((w > 0) & (w < 1)).all())


def test_head_norm_is_over_the_whole_width():
    """The reference's "head norm" is one RMS norm over all of D (not per
    head): scaling one head's output changes the other heads' normed
    values."""
    from repro_torch.models.common import rms_norm

    y = torch.randn(1, 1, 256, generator=torch.Generator().manual_seed(1))
    w = torch.ones(256)
    y2 = y.clone()
    y2[..., :64] *= 10
    assert not torch.allclose(rms_norm(y, w)[..., 64:],
                              rms_norm(y2, w)[..., 64:])


def test_lm_params_from_reference_rejects_wrong_layer_axis(ref):
    tree = nest(ref, "d64/p/")
    tree["layers"]["tm"]["w_r"] = tree["layers"]["tm"]["w_r"][:1]
    with pytest.raises(ValueError, match="leading axis"):
        lm_params_from_reference(tree, _cfg(64))


def test_lm_params_cover_the_model_exactly(ref, models):
    sd = lm_params_from_reference(nest(ref, "d256/p/"), _cfg(256))
    assert set(sd) == set(models[256].state_dict())
    for k, t in models[256].state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
