"""The RG-LRU recurrence: the port's plain torch version and its wrapper
against the reference's oracles (the sequential ``rglru_ref``, the
associative ``rglru_assoc_ref`` and the Pallas kernel ``ops.rglru`` in
interpret mode) from a zero state, at ``tests/test_kernels.py``'s shapes
and three on the CUDA kernels' boundaries, and against the model's ``_assoc_scan`` from a nonzero start state; the
identity decay; the wrapper's input checks; and the CUDA kernel against
the plain version on the card, bit for bit.

Inputs are float32 as ``tests/test_kernels.py`` draws them:
``a = sigmoid(n) * 0.9``, ``b = 0.3 n``, with the start state ``h0``
standard normal.

Tolerance: max |error| <= 1e-6 x M, where M is the largest value the
recurrence reaches on |a|, |b|, |h0| (M >= max |h|). The reference's
scans round in other places than the plain loop (the associative scan
re-associates the products; XLA may fuse a*h + b into one FMA); the
error scales with M, not with the output, which can cancel to near
zero. Measured on the CPU: 5e-8 to 7e-8 of M.
"""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.kernels.rglru import (
    launch_count,
    rglru,
    rglru_assoc_plain,
    rglru_plain,
)

RTOL = 1e-6                # of the magnitude scale M (module docstring)
# (B, T, C); the last three land on the CUDA kernels' boundaries: one
# decode step at a C that is no multiple of the blocks, T past three
# 32-step ring stages and a tail at C % 4 == 0 but no multiple of 32, and
# a C that is no multiple of 4 (4-byte copies)
SHAPES = [(2, 64, 128), (1, 80, 200), (3, 33, 64), (2, 1, 132),
          (1, 97, 260), (2, 33, 130)]
IMPLS = {"plain": rglru_plain, "wrapper": rglru}


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    a = 0.9 / (1.0 + np.exp(-rng.standard_normal(shape)))
    b = 0.3 * rng.standard_normal(shape)
    h0 = rng.standard_normal((shape[0], shape[2]))
    return {n: x.astype(np.float32) for n, x in
            (("a", a), ("b", b), ("h0", h0))}


def _name(shape):
    return "x".join(map(str, shape))


REF = """
import jax.numpy as jnp
from repro.kernels.rglru import rglru, rglru_assoc_ref, rglru_ref
from repro.models.rglru import _assoc_scan
for c in inp["names"]:
    a, b, h0 = (jnp.asarray(inp[f"{c}_{n}"]) for n in ("a", "b", "h0"))
    out[f"{c}_seq"] = rglru_ref(a, b)
    out[f"{c}_assoc"] = rglru_assoc_ref(a, b)
    out[f"{c}_pallas"] = rglru(a, b, interpret=True)
    out[f"{c}_model0"] = _assoc_scan(a, b)
    out[f"{c}_model"] = _assoc_scan(a, b, h0)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"names": np.array([_name(s) for s in SHAPES])}
    for i, shape in enumerate(SHAPES):
        for n, x in _case(shape, seed=i).items():
            inputs[f"{_name(shape)}_{n}"] = x
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_rglru"))


def magnitude(a, b, h0=None) -> float:
    """M: the recurrence on absolute values, maxed."""
    h0 = None if h0 is None else torch.as_tensor(h0).abs()
    h, _ = rglru_plain(torch.as_tensor(a).abs(), torch.as_tensor(b).abs(),
                       h0)
    return float(h.max())


def _close(got, want, scale, what):
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


def _t(c, *names):
    return [torch.as_tensor(c[n]) for n in names]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("oracle", ["seq", "assoc", "pallas", "model0"])
@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_rglru_zero_state_matches_reference(ref, shape, oracle, impl):
    c = _case(shape, seed=SHAPES.index(shape))
    before = launch_count()
    h, h_t = IMPLS[impl](*_t(c, "a", "b"))
    assert launch_count() == before            # the CPU never launches
    assert h.dtype == h_t.dtype == torch.float32
    assert torch.equal(h_t, h[:, -1])
    _close(h, ref[f"{_name(shape)}_{oracle}"], magnitude(c["a"], c["b"]),
           f"h vs {oracle}")


@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_rglru_assoc_plain_matches_reference_assoc(ref, shape):
    """The associative-scan order, ``rglru_assoc_ref``'s, in plain
    torch."""
    c = _case(shape, seed=SHAPES.index(shape))
    h = rglru_assoc_plain(*_t(c, "a", "b"))
    assert h.dtype == torch.float32
    _close(h, ref[f"{_name(shape)}_assoc"], magnitude(c["a"], c["b"]),
           "h vs assoc")


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_rglru_start_state_matches_model_scan(ref, shape, impl):
    """``_assoc_scan(a, b, h0)``, the function the serving path needs."""
    c = _case(shape, seed=SHAPES.index(shape))
    h, h_t = IMPLS[impl](*_t(c, "a", "b", "h0"))
    m = magnitude(c["a"], c["b"], c["h0"])
    want = ref[f"{_name(shape)}_model"]
    _close(h, want, m, "h")
    _close(h_t, want[:, -1], m, "h_T")


def test_h_out_aliasing_h0_updates_in_place():
    c = _case((3, 33, 64), seed=5)
    a, b, h0 = _t(c, "a", "b", "h0")
    h_ref, t_ref = rglru(a, b, h0.clone())
    state = h0.clone()
    h, h_t = rglru(a, b, state, h_out=state)
    assert h_t.data_ptr() == state.data_ptr()
    assert torch.equal(h, h_ref) and torch.equal(state, t_ref)


def test_one_step_is_the_update():
    """T = 1 (a decode step): h = a * h0 + b, rounded twice."""
    c = _case((4, 1, 200), seed=6)
    a, b, h0 = _t(c, "a", "b", "h0")
    h, h_t = rglru(a, b, h0)
    assert torch.equal(h_t, a[:, 0] * h0 + b[:, 0])
    assert torch.equal(h[:, 0], h_t)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_identity_decay_is_a_cumulative_sum(impl):
    """a == 1 everywhere -> cumulative sum of the inputs."""
    b = torch.ones((1, 10, 8))
    h, h_t = IMPLS[impl](torch.ones_like(b), b)
    assert torch.equal(h[0, :, 0], torch.arange(1, 11, dtype=torch.float32))
    assert torch.equal(h_t, torch.full((1, 8), 10.0))


def _bad(kind):
    c = _case((2, 5, 16), seed=3)
    a, b, h0 = _t(c, "a", "b", "h0")
    kw = {}
    if kind == "float64":
        a = a.double()
    elif kind == "shape":
        b = b[:, :-1].contiguous()
    elif kind == "rank":
        a, b = a[0], b[0]
    elif kind == "empty_T":
        a, b = a[:, :0].contiguous(), b[:, :0].contiguous()
    elif kind == "strided":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    elif kind == "h0_shape":
        kw["h0"] = h0[:, :-1].contiguous()
    elif kind == "h_out_dtype":
        kw["h_out"] = h0.double()
    elif kind == "device":
        kw["h0"] = h0.to("meta")
    return (a, b), kw


@pytest.mark.parametrize("kind,exc", [
    ("float64", TypeError), ("shape", ValueError), ("rank", ValueError),
    ("empty_T", ValueError), ("strided", ValueError),
    ("h0_shape", ValueError), ("h_out_dtype", TypeError),
    ("device", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    args, kw = _bad(kind)
    with pytest.raises(exc):
        rglru(*args, **kw)


# On the card: the existing shapes, then every T that lands on or next to
# a ring boundary (one step, a partial stage, one stage, one past it,
# three stages and a tail, the serving prefill) at C not a multiple of 4,
# C past a partial block and the serving width, from zeros and from a
# start state; then tensors that start 4 bytes past a 16-byte boundary
# (the 4-byte copy and scalar step variants).
CARD_CASES = ([((4, 3072, 4096), "zero", 0), ((4, 1, 4096), "nonzero", 0),
               ((1, 37, 200), "zero", 0), ((3, 33, 64), "nonzero", 0)]
              + [((2, t, c), start, 0) for t in (1, 31, 32, 33, 97, 3072)
                 for c in (130, 200, 4096) for start in ("zero", "nonzero")]
              + [((2, t, c), "nonzero", 1) for t in (1, 33, 97)
                 for c in (200, 4096)])


def _offset(x, floats):
    """``x`` copied into a contiguous tensor that starts ``floats``
    elements past the start of its storage."""
    if not floats:
        return x
    buf = torch.empty(x.numel() + floats, dtype=x.dtype, device=x.device)
    out = buf[floats:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,start,offset", CARD_CASES)
def test_cuda_kernel_equals_plain_on_card(shape, start, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    c = _case(shape, seed=sum(shape))
    a, b, h0 = (_offset(t.cuda(), offset) for t in _t(c, "a", "b", "h0"))
    h0 = h0 if start == "nonzero" else None
    before = launch_count()
    h, h_t = rglru(a, b, h0)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    h_p, t_p = rglru_plain(a, b, h0)
    assert torch.equal(h, h_p) and torch.equal(h_t, t_p)
    if h0 is not None:                          # in place on the card too
        state = _offset(h0.clone(), offset)
        h_i, t_i = rglru(a, b, state, h_out=state)
        torch.cuda.synchronize()
        assert t_i.data_ptr() == state.data_ptr()
        assert torch.equal(state, t_p) and torch.equal(h_i, h_p)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("shape", [(2, 1, 200), (2, 97, 4096), (3, 33, 130)])
def test_cuda_gradients_equal_plain_autograd_on_card(shape, start):
    """The autograd node on the card (backward: the kernel over the
    reversed sequence) against autograd through the plain version on the
    card, within 1e-5 of each gradient's max |value|; the forward and
    the backward launch once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    c = _case(shape, seed=sum(shape) + 1)
    a, b, h0 = (t.cuda().requires_grad_() for t in _t(c, "a", "b", "h0"))
    args = (a, b, h0) if start == "nonzero" else (a, b)
    g = torch.randn_like(a)
    g_fin = torch.randn_like(a[:, 0])
    before = launch_count()
    got = torch.autograd.grad(rglru(*args), args, (g, g_fin))
    assert launch_count() == before + 2
    want = torch.autograd.grad(rglru_plain(*args), args, (g, g_fin))
    for x, p in zip(got, want):
        assert float((x - p).abs().max()) <= 1e-5 * float(p.abs().max())
