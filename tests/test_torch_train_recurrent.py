"""Training the ssm and hybrid families against the reference, and the
gradients of the two recurrences under them.

- The autograd nodes of ``kernels.rglru.rglru`` (backward: the adjoint
  recurrence run backward in time through the same kernel, here its
  plain version) and ``kernels.wkv6.wkv6`` (backward: the plain
  recurrence recomputed under autograd) against ``jax.vjp`` of the
  reference's ``models/rglru.py::_assoc_scan`` and
  ``models/rwkv6.py::wkv_scan``, with and without a start state, under
  cotangents of both the sequence and the returned final state; within
  1e-5 of each gradient's max |value| (measured on the CPU: at most
  1.1e-7 for ``rglru``, 3.7e-7 for ``wkv6``). Each refuses the in-place
  state write when an input requires grad.
- The reduced ``rwkv6-3b`` (2 layers, one head of 64; batch 2 x 48) and
  the reduced ``recurrentgemma-9b`` at 5 layers (one group and the
  2-layer tail, window 32; batch 2 x 80, so the window bites): five
  steps, the first step's gradients and the checkpoints both ways, by
  ``tests/test_torch_train_support.py`` (its docstring gives the
  tolerances).
"""
import numpy as np
import pytest
import torch

from test_torch_train_support import (
    check_decay_mask,
    check_first_step_gradients,
    check_five_steps,
    check_port_checkpoint,
    check_reference_checkpoint,
    run_family_reference,
)

from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.wkv6 import wkv6

TAGS = ("rwkv6", "hybrid")
GRAD_TOL = 1e-5            # of each gradient's max |value|
RG = (2, 40, 24)           # (B, T, C)
WKV = (2, 24, 2, 64)       # (B, T, H, D)

FUNCTIONS = """
import jax.numpy as jnp
from repro.models.rglru import _assoc_scan
from repro.models.rwkv6 import wkv_scan


def rg_final(a, b, h0=None):
    h = _assoc_scan(a, b, h0)
    return h, h[:, -1]


rg = {n: jnp.asarray(inp["rg_" + n]) for n in ("a", "b", "h0", "g", "gf")}
_, vjp = jax.vjp(rg_final, rg["a"], rg["b"], rg["h0"])
out.update(zip(("rg/h0/da", "rg/h0/db", "rg/h0/dh0"),
               vjp((rg["g"], rg["gf"]))))
_, vjp = jax.vjp(rg_final, rg["a"], rg["b"])
out.update(zip(("rg/zero/da", "rg/zero/db"), vjp((rg["g"], rg["gf"]))))
wk = {n: jnp.asarray(inp["wk_" + n])
      for n in ("r", "k", "v", "w", "u", "s0", "gy", "gs")}
names = ("r", "k", "v", "w", "u", "s0")
_, vjp = jax.vjp(wkv_scan, *(wk[n] for n in names))
out.update(zip((f"wk/s0/d{n}" for n in names), vjp((wk["gy"], wk["gs"]))))
_, vjp = jax.vjp(wkv_scan, *(wk[n] for n in names[:5]))
out.update(zip((f"wk/zero/d{n}" for n in names[:5]),
               vjp((wk["gy"], wk["gs"]))))
"""


def _inputs():
    rng = np.random.default_rng(7)
    b, t, c = RG
    a = 0.9 / (1.0 + np.exp(-rng.standard_normal(RG)))
    arrays = {"rg_a": a, "rg_b": 0.3 * rng.standard_normal(RG),
              "rg_h0": rng.standard_normal((b, c)),
              "rg_g": rng.standard_normal(RG),
              "rg_gf": rng.standard_normal((b, c))}
    b, t, h, d = WKV
    arrays.update(
        wk_r=rng.standard_normal(WKV), wk_k=rng.standard_normal(WKV),
        wk_v=rng.standard_normal(WKV),
        wk_w=np.exp(-np.exp(-6 + rng.standard_normal(WKV))),
        wk_u=0.5 * rng.standard_normal((h, d)),
        wk_s0=rng.standard_normal((b, h, d, d)),
        wk_gy=rng.standard_normal(WKV),
        wk_gs=rng.standard_normal((b, h, d, d)))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_family_reference(TAGS, tmp_path_factory, FUNCTIONS, _inputs())


def _grad_close(got, want, what):
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * scale, f"{what}: {err} > {GRAD_TOL} x {scale}"


def _leaves(prefix, names):
    arrays = _inputs()
    return [torch.tensor(arrays[prefix + n], requires_grad=True)
            for n in names]


@pytest.mark.parametrize("start", ["h0", "zero"])
def test_rglru_gradients_match_reference(ref, start):
    a, b, h0, g, gf = _leaves("rg_", ("a", "b", "h0", "g", "gf"))
    args = (a, b, h0) if start == "h0" else (a, b)
    h, h_t = rglru(*args)
    grads = torch.autograd.grad((h, h_t), args, (g, gf))
    for name, got in zip(("a", "b", "h0"), grads):
        _grad_close(got, ref[0][f"rg/{start}/d{name}"], f"d{name}")


@pytest.mark.parametrize("start", ["s0", "zero"])
def test_wkv6_gradients_match_reference(ref, start):
    names = ("r", "k", "v", "w", "u", "s0")
    xs = _leaves("wk_", names + ("gy", "gs"))
    args = tuple(xs[:6] if start == "s0" else xs[:5])
    y, s = wkv6(*args)
    grads = torch.autograd.grad((y, s), args, (xs[6], xs[7]))
    for name, got in zip(names, grads):
        _grad_close(got, ref[0][f"wk/{start}/d{name}"], f"d{name}")


def test_in_place_state_write_refused_under_grad():
    a, b, h0 = _leaves("rg_", ("a", "b", "h0"))
    with pytest.raises(ValueError, match="h_out"):
        rglru(a, b, h0, h_out=h0.detach().clone())
    r, k, v, w, u, s0 = _leaves("wk_", ("r", "k", "v", "w", "u", "s0"))
    with pytest.raises(ValueError, match="s_out"):
        wkv6(r, k, v, w, u, s0, s_out=s0.detach().clone())
    with torch.no_grad():                    # the decode path writes in place
        state = s0.detach().clone()
        _, s = wkv6(r.detach(), k.detach(), v.detach(), w.detach(),
                    u.detach(), state, s_out=state)
    assert s.data_ptr() == state.data_ptr()


@pytest.mark.parametrize("tag", TAGS)
def test_five_steps_match_reference(ref, tag):
    check_five_steps(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_first_step_gradients_match_reference(ref, tag):
    check_first_step_gradients(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_decay_mask_matches_reference(ref, tag):
    check_decay_mask(ref[0], tag)


@pytest.mark.parametrize("tag", TAGS)
def test_reference_checkpoint_restores_into_the_port(ref, tag):
    check_reference_checkpoint(*ref, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_port_checkpoint_restores_into_the_reference(ref, tag):
    check_port_checkpoint(ref[0], tag)
