"""The port's AdamW and int8 error-feedback compression against the
reference's ``repro.optim``.

The parameters are the reduced ``smollm-135m``'s (2 layers, d_model
64), drawn by the reference's ``init_model``, with every norm weight
drawn non-default, and four steps of gradients drawn with numpy from a
seed (the first scaled so the global norm exceeds the clip and the
others under it).

- ``schedule`` at warmup, peak, cosine and past the end (float32; both
  sides compute it in float32 from an int32 step: within 1e-6).
- ``apply_updates`` four steps from ``init``: every parameter, both
  moments, the step counter, the global norm and the learning rate after
  each step. Tolerance 1e-6 of each leaf's max |value| (measured on the
  CPU: at most ~1e-7; the two sides sum the norm in another order).
- The decay mask: the reference decays its *stacked* leaves of rank 2,
  so a layer's norm weight, (D,) in the port and (L, D) there, decays,
  and ``final_norm`` does not. With zero gradients only the decay moves
  a parameter, so the port's step must give the reference's exactly
  those leaves.
- ``compress_with_feedback`` / ``decompress`` twice (the second with
  the carried error) on the reference's leaves: the int8 payloads and the
  scales equal, the error and the reconstruction within 1e-6 of the
  leaf's max |value|.
"""
import numpy as np
import pytest
import torch

from test_torch_support import FLAT, nest, run_reference

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference
from repro_torch.models.transformer import init_model
from repro_torch.optim import adamw, compression

RTOL = 1e-6
STEPS = 4
SCHED_STEPS = (0, 1, 4, 9, 10, 11, 50, 99, 100, 140)
OPT = dict(lr_peak=3e-3, lr_min=3e-4, warmup_steps=10, total_steps=100,
           weight_decay=0.1, clip_norm=1.0)


def _cfg():
    return get_config("smollm-135m").reduced()


REF = FLAT + """
import jax.numpy as jnp
from repro.configs import get_config
from repro.models.transformer import init_model
from repro.optim import adamw, compression

cfg = get_config("smollm-135m").reduced()
params = init_model(jax.random.PRNGKey(5), cfg)
lay = params["layers"]
lay["ln1"], lay["ln2"] = jnp.asarray(inp["ln1"]), jnp.asarray(inp["ln2"])
params["final_norm"] = jnp.asarray(inp["final_norm"])
out.update(flat(params, "p0/"))
opt = adamw.AdamWConfig(**OPT)
for s in SCHED:
    out[f"sched/{s}"] = adamw.schedule(opt, jnp.asarray(s, jnp.int32))
names = sorted(flat(params, ""))


def nest_ref(d):
    res = {}
    for k, v in d.items():
        node = res
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return res


state = adamw.init(params, opt)
p = params
for i in range(STEPS):
    grads = nest_ref({k: inp[f"g{i}/" + k] for k in names})
    p, state, m = adamw.apply_updates(p, grads, state, opt)
    out.update(flat(p, f"p{i + 1}/"))
    out.update(flat(state.mu, f"mu{i + 1}/"))
    out.update(flat(state.nu, f"nu{i + 1}/"))
    out[f"step{i + 1}"] = state.step
    out[f"gnorm{i + 1}"], out[f"lr{i + 1}"] = m["grad_norm"], m["lr"]
zero = jax.tree_util.tree_map(jnp.zeros_like, params)
p, _, _ = adamw.apply_updates(params, zero, adamw.init(params, opt), opt)
out.update(flat(p, "decayed/"))
g = nest_ref({k: inp["g0/" + k] for k in names})
err = compression.init_error(g)
for i in range(2):
    c, err = compression.compress_with_feedback(g, err)
    out.update(flat(c.q, f"q{i}/"))
    out.update(flat(c.scale, f"scale{i}/"))
    out.update(flat(err, f"err{i}/"))
    out.update(flat(compression.decompress(c, g), f"dec{i}/"))
"""


def _inputs():
    rng = np.random.default_rng(31)
    cfg = _cfg()
    L, d = cfg.n_layers, cfg.d_model
    inp = {"ln1": (1 + 0.2 * rng.standard_normal((L, d))).astype(np.float32),
           "ln2": (1 + 0.2 * rng.standard_normal((L, d))).astype(np.float32),
           "final_norm": (1 + 0.2 * rng.standard_normal(d)).astype(
               np.float32)}
    return inp, rng


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inp, rng = _inputs()
    # the reference tree's leaves: the port model's, stacked per layer
    model = init_model(_cfg(), torch_device="cpu")
    shapes = {}
    stack = [("", lm_params_to_reference(dict(model.named_parameters())))]
    while stack:
        pre, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((pre + k + "/", v))
            else:
                shapes[pre + k] = v.shape
    for i in range(STEPS):
        scale = 0.5 if i == 0 else 0.002
        for k, shp in shapes.items():
            inp[f"g{i}/{k}"] = (scale * rng.standard_normal(tuple(shp))
                                ).astype(np.float32)
    consts = f"OPT = {OPT!r}\nSCHED = {SCHED_STEPS!r}\nSTEPS = {STEPS}\n"
    out = run_reference(consts + REF, inp,
                        tmp_path_factory.mktemp("ref_optim"))
    out["_inp"] = inp
    return out


def _port(ref, prefix):
    return {k: v.clone() for k, v in lm_params_from_reference(
        nest(ref, prefix), _cfg()).items()}


def _grads(ref, i):
    return _port({f"g/{k[len(f'g{i}/'):]}": v for k, v in
                  ref["_inp"].items() if k.startswith(f"g{i}/")}, "g/")


def _close(got, want, what, rtol=RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


@pytest.mark.parametrize("step", SCHED_STEPS)
def test_schedule_matches_reference(ref, step):
    got = adamw.schedule(adamw.AdamWConfig(**OPT),
                         torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    _close(got, ref[f"sched/{step}"], f"lr at {step}")


def test_apply_updates_matches_reference(ref):
    opt = adamw.AdamWConfig(**OPT)
    params = _port(ref, "p0/")
    state = adamw.init(params, opt)
    for i in range(STEPS):
        params, state, m = adamw.apply_updates(params, _grads(ref, i),
                                               state, opt)
        assert int(state.step) == int(ref[f"step{i + 1}"]) == i + 1
        _close(m["grad_norm"], ref[f"gnorm{i + 1}"], f"gnorm {i}")
        _close(m["lr"], ref[f"lr{i + 1}"], f"lr {i}")
        for tag, tree in (("p", params), ("mu", state.mu), ("nu", state.nu)):
            want = _port(ref, f"{tag}{i + 1}/")
            assert set(want) == set(tree)
            for k in want:
                _close(tree[k], want[k], f"step {i}: {tag} {k}")
    # the first step's gradients exceed the clip norm, the others do not
    assert float(ref["gnorm1"]) > OPT["clip_norm"] > float(ref["gnorm2"])


def test_clip_by_global_norm(ref):
    grads = _grads(ref, 0)
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    _close(norm, ref["gnorm1"], "norm")
    _close(adamw.global_norm(clipped), np.float32(1.0), "clipped norm")
    small, _ = adamw.clip_by_global_norm(grads, 1e9)
    assert all(torch.equal(small[k], grads[k]) for k in grads)


def test_decay_follows_the_reference_stacked_leaves(ref):
    """With zero gradients only the decoupled decay moves a parameter:
    every per-layer leaf (norm weights too) and the 2-D embedding decay,
    the final norm does not, as in the reference."""
    opt = adamw.AdamWConfig(**OPT)
    params = _port(ref, "p0/")
    before = {k: v.clone() for k, v in params.items()}
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    params, _, _ = adamw.apply_updates(params, zero,
                                       adamw.init(params, opt), opt)
    want = _port(ref, "decayed/")
    for k in params:
        _close(params[k], want[k], k)
        decays = k != "final_norm"
        assert (not torch.equal(params[k], before[k])) == decays, k
    assert adamw.reference_ndim("layers.0.ln1", before["layers.0.ln1"]) == 2
    assert adamw.reference_ndim("final_norm", before["final_norm"]) == 1


def test_compression_matches_reference(ref):
    """On the reference's own leaves (stacked per layer), so each block
    of 256 values is the same on both sides."""
    g = {k[3:]: torch.as_tensor(v) for k, v in ref["_inp"].items()
         if k.startswith("g0/")}
    err = compression.init_error(g)
    for i in range(2):
        c, err = compression.compress_with_feedback(g, err)
        dec = compression.decompress(c, g)
        for k in g:
            assert c.q[k].dtype == torch.int8
            assert np.array_equal(c.q[k].numpy(), ref[f"q{i}/{k}"]), (i, k)
            assert np.array_equal(c.scale[k].numpy(),
                                  ref[f"scale{i}/{k}"]), (i, k)
            _close(err[k], ref[f"err{i}/{k}"], f"err {i} {k}")
            _close(dec[k], ref[f"dec{i}/{k}"], f"dec {i} {k}")
            assert dec[k].shape == g[k].shape and dec[k].dtype == g[k].dtype
