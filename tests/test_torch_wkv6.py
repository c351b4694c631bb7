"""The WKV recurrence: the port's plain torch version and its wrapper
against the reference's jnp oracle (``wkv6_ref_vmapped``) and its Pallas
kernel in interpret mode (``ops.wkv6``), both from a zero state with
``u`` per row, and against the model's ``wkv_scan`` with a per-head ``u``
from a zero and from a nonzero start state, for both ``y`` and the final
state, in the (G, T, D) rows and in the model's (B, T, H, D) layout; the
wrapper's input checks; and the CUDA kernel against the plain version on
the card, at shapes that cross its partition (row, column block, chunk),
in both layouts, in place, and in a small-decay regime.

Inputs are float32 with decays from the model's regime,
``w = exp(-exp(-6 + noise))`` (about 0.9975), where the state grows with
T, and ``u`` at the model's one-head init scale (std 0.5).

Tolerance: max |error| <= 1e-6 x M, where M is the largest sum of
absolute terms that an output accumulates: the same recurrence run on
|r|, |k|, |v|, w, |u|, |s0| (M >= max |y|, resp. max |S|). Two float32
evaluations differ by summation order only, an error that scales with M
and not with the output, which can cancel to near zero (at T = 1 and a
zero state, y = v * sum_k r_k u_k k_k). Measured on the CPU: 2e-8 to
1e-7 of M, which is 1e-7 to 5e-7 of max |y|.
"""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.kernels.wkv6 import launch_count, wkv6, wkv6_plain
from repro_torch.models.rwkv6 import wkv_scan

D = 64
RTOL = 1e-6                # of the magnitude scale M (module docstring)
CASES = [(1, 1), (1, 37), (1, 64), (8, 1), (8, 37), (8, 64)]   # (G, T)
IMPLS = {"plain": wkv6_plain, "wrapper": wkv6}


def _bh(g):
    """The (B, H) split of G for the model's (B, S, H, Dh) layout."""
    return (1, 1) if g == 1 else (2, g // 2)


def _case(g, t, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((g, t, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(-6.0 + rng.standard_normal((g, t, D))))
    b, h = _bh(g)
    return dict(r=r, k=k, v=v, w=w.astype(np.float32),
                u=(0.5 * rng.standard_normal((g, D))).astype(np.float32),
                uh=(0.5 * rng.standard_normal((h, D))).astype(np.float32),
                s0=rng.standard_normal((b, h, D, D)).astype(np.float32))


def _name(g, t):
    return f"g{g}t{t}"


def _bshd(x, g):
    """(G, T, D) with rows g = b*H + h -> the model's (B, T, H, D)."""
    b, h = _bh(g)
    return np.ascontiguousarray(
        x.reshape(b, h, x.shape[1], D).transpose(0, 2, 1, 3))


REF = """
import jax.numpy as jnp
from repro.kernels.wkv6 import wkv6, wkv6_ref_vmapped
from repro.models.rwkv6 import wkv_scan
for c in inp["names"]:
    r, k, v, w, u, uh, s0 = (jnp.asarray(inp[f"{c}_{n}"]) for n in
                             ("r", "k", "v", "w", "u", "uh", "s0"))
    out[f"{c}_ref_y"] = wkv6_ref_vmapped(r, k, v, w, u)
    out[f"{c}_pl_y"] = wkv6(r, k, v, w, u, interpret=True)
    b, h = s0.shape[:2]
    g, t, d = r.shape
    def bshd(x):
        return x.reshape(b, h, t, d).transpose(0, 2, 1, 3)
    for tag, start in (("scan0", None), ("scan", s0)):
        y, s = wkv_scan(*(bshd(x) for x in (r, k, v, w)), uh, start)
        out[f"{c}_{tag}_y"], out[f"{c}_{tag}_s"] = y, s
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"names": np.array([_name(g, t) for g, t in CASES])}
    for i, (g, t) in enumerate(CASES):
        for n, a in _case(g, t, seed=i).items():
            inputs[f"{_name(g, t)}_{n}"] = a
    return run_reference(REF, inputs, tmp_path_factory.mktemp("ref_wkv6"))


def magnitude(r, k, v, w, u, s0=None):
    """(M_y, M_S): the recurrence on absolute values, maxed."""
    a = [torch.as_tensor(x).abs() for x in (r, k, v)]
    s0 = None if s0 is None else torch.as_tensor(s0).abs()
    y, s = wkv6_plain(*a, torch.as_tensor(w), torch.as_tensor(u).abs(), s0)
    return float(y.max()), float(s.max())


def _close(got, want, scale, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} x {scale}"


def _t(c, *names, device="cpu"):
    return [torch.as_tensor(c[n], device=device) for n in names]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("oracle", ["ref", "pl"])
@pytest.mark.parametrize("g,t", CASES)
def test_wkv6_zero_state_matches_reference_kernel(ref, g, t, oracle, impl):
    c = _case(g, t, seed=CASES.index((g, t)))
    before = launch_count()
    y, s = IMPLS[impl](*_t(c, "r", "k", "v", "w", "u"))
    assert launch_count() == before            # the CPU never launches
    assert y.dtype == s.dtype == torch.float32 and s.shape == (g, D, D)
    m_y, _ = magnitude(*(c[n] for n in ("r", "k", "v", "w", "u")))
    _close(y, ref[f"{_name(g, t)}_{oracle}_y"], m_y, f"y vs {oracle}")


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("g,t", CASES)
def test_wkv6_state_in_and_out_matches_wkv_scan(ref, g, t, start, impl):
    """Rows g = b*H + h read the per-head u (H, D) as row g % H, and the
    state (B, H, Dk, Dv) is the kernel's (G, Dk, Dv)."""
    c = _case(g, t, seed=CASES.index((g, t)))
    tag = "scan" if start == "nonzero" else "scan0"
    s0 = (torch.as_tensor(c["s0"]).reshape(g, D, D)
          if start == "nonzero" else None)
    y, s = IMPLS[impl](*_t(c, "r", "k", "v", "w", "uh"), s0)
    m_y, m_s = magnitude(*(c[n] for n in ("r", "k", "v", "w", "uh")), s0)
    want_y = ref[f"{_name(g, t)}_{tag}_y"]                 # (B, T, H, D)
    b, h = _bh(g)
    _close(y.reshape(b, h, t, D).permute(0, 2, 1, 3), want_y, m_y, "y")
    _close(s.reshape(b, h, D, D), ref[f"{_name(g, t)}_{tag}_s"], m_s,
           "S_T")


@pytest.mark.parametrize("g,t", CASES)
def test_model_wkv_scan_matches_reference(ref, g, t):
    """The port's ``wkv_scan`` on the model's (B, S, H, Dh) layout; the
    start state is updated in place and returned."""
    c = _case(g, t, seed=CASES.index((g, t)))
    r, k, v, w = (torch.as_tensor(_bshd(c[n], g)) for n in "rkvw")
    s0 = torch.as_tensor(c["s0"]).clone()
    rows = [c[n] for n in ("r", "k", "v", "w", "uh")]
    m_y, m_s = magnitude(*rows, c["s0"].reshape(g, D, D))
    m0_y, m0_s = magnitude(*rows)
    y, s = wkv_scan(r, k, v, w, torch.as_tensor(c["uh"]), s0)
    _close(y, ref[f"{_name(g, t)}_scan_y"], m_y, "y")
    _close(s, ref[f"{_name(g, t)}_scan_s"], m_s, "S_T")
    assert s.data_ptr() == s0.data_ptr()                   # in place
    y0, s_zero = wkv_scan(r, k, v, w, torch.as_tensor(c["uh"]))
    _close(y0, ref[f"{_name(g, t)}_scan0_y"], m0_y, "y (zero start)")
    _close(s_zero, ref[f"{_name(g, t)}_scan0_s"], m0_s, "S_T (zero start)")


def test_wkv_scan_batch_of_one_lays_out_heads_as_rows():
    """At B = 1 the rows g = h of the (1, S, H, Dh) layout are strided;
    ``wkv_scan`` passes the layout as it lies and rows g = h come out."""
    c = _case(8, 37, seed=4)
    r, k, v, w = (torch.as_tensor(c[n][None]).permute(0, 2, 1, 3)
                  .contiguous() for n in "rkvw")            # (1, T, 8, D)
    u = torch.as_tensor(c["u"])
    y, s = wkv_scan(r, k, v, w, u)
    y_p, s_p = wkv6_plain(*_t(c, "r", "k", "v", "w", "u"))
    assert torch.equal(y[0].transpose(0, 1), y_p)
    assert torch.equal(s[0], s_p)


def test_per_head_u_equals_expanded_u():
    """u (H, D) read as row g % H is u expanded to (G, D), exactly."""
    c = _case(8, 37, seed=1)
    r, k, v, w, uh = _t(c, "r", "k", "v", "w", "uh")
    y1, s1 = wkv6(r, k, v, w, uh)
    y2, s2 = wkv6(r, k, v, w, uh.repeat(2, 1))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_s_out_aliasing_s0_updates_in_place():
    c = _case(8, 37, seed=2)
    args = _t(c, "r", "k", "v", "w", "uh")
    s0 = torch.as_tensor(c["s0"]).reshape(8, D, D)
    y_ref, s_ref = wkv6(*args, s0.clone())
    state = s0.clone()
    y, s = wkv6(*args, state, s_out=state)
    assert s.data_ptr() == state.data_ptr()
    assert torch.equal(y, y_ref) and torch.equal(state, s_ref)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("g,t", CASES)
def test_wkv6_model_layout_matches_rows_and_wkv_scan(ref, g, t, start,
                                                     impl):
    """(B, T, H, D) inputs and a (B, H, D, D) state give y in that layout
    and the state in that shape: equal to the (G, T, D) rows' results,
    and within tolerance of the reference's ``wkv_scan``."""
    c = _case(g, t, seed=CASES.index((g, t)))
    b, h = _bh(g)
    tag = "scan" if start == "nonzero" else "scan0"
    s0 = (torch.as_tensor(c["s0"]) if start == "nonzero" else None)
    r, k, v, w = (torch.as_tensor(_bshd(c[n], g)) for n in "rkvw")
    uh = torch.as_tensor(c["uh"])
    y, s = IMPLS[impl](r, k, v, w, uh, s0)
    assert y.shape == (b, t, h, D) and s.shape == (b, h, D, D)
    assert y.is_contiguous()
    y3, s3 = IMPLS[impl](*_t(c, "r", "k", "v", "w", "uh"),
                         None if s0 is None else s0.reshape(g, D, D))
    assert torch.equal(y.permute(0, 2, 1, 3).reshape(g, t, D), y3)
    assert torch.equal(s.reshape(g, D, D), s3)
    m_y, m_s = magnitude(*(c[n] for n in ("r", "k", "v", "w", "uh")),
                         None if s0 is None else s0.reshape(g, D, D))
    _close(y, ref[f"{_name(g, t)}_{tag}_y"], m_y, "y")
    _close(s, ref[f"{_name(g, t)}_{tag}_s"], m_s, "S_T")


def test_wkv_scan_hands_the_kernel_its_tensors_without_copies(monkeypatch):
    """The model's float32 (B, S, H, Dh) tensors and its state slab reach
    the kernel wrapper as they are: no layout copy before or after."""
    from repro_torch.models import rwkv6 as rwkv_mod

    c = _case(8, 37, seed=5)
    r, k, v, w = (torch.as_tensor(_bshd(c[n], 8)) for n in "rkvw")
    s0 = torch.as_tensor(c["s0"]).clone()
    seen = {}
    real = rwkv_mod.wkv6_ops.wkv6

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["out"] = real(*args, **kw)
        return seen["out"]

    monkeypatch.setattr(rwkv_mod.wkv6_ops, "wkv6", spy)
    y, s = wkv_scan(r, k, v, w, torch.as_tensor(c["uh"]), s0)
    assert [x.data_ptr() for x in seen["args"][:4]] == \
        [x.data_ptr() for x in (r, k, v, w)]
    assert seen["args"][5] is s0 and seen["kw"]["s_out"] is s0
    assert y is seen["out"][0] and s is s0


def _bad(kind):
    c = _case(8, 5, seed=3)
    a = dict(zip("rkvwu", _t(c, "r", "k", "v", "w", "uh")))
    kw = {}
    if kind == "float64":
        a["r"] = a["r"].double()
    elif kind == "shape":
        a["k"] = a["k"][:, :-1].contiguous()
    elif kind == "unsupported_D":
        a = {n: x[..., :32].contiguous() for n, x in a.items()}
    elif kind == "u_rows":
        a["u"] = torch.zeros((3, D))
    elif kind == "empty_T":
        a = {n: (x[:, :0].contiguous() if n != "u" else x)
             for n, x in a.items()}
    elif kind == "strided":
        a["v"] = a["v"].transpose(0, 1).contiguous().transpose(0, 1)
    elif kind == "s0_shape":
        kw["s0"] = torch.zeros((8, D, D - 1))
    elif kind == "s_out_dtype":
        kw["s_out"] = torch.zeros((8, D, D), dtype=torch.float64)
    elif kind.endswith("_4d"):                    # the (B, T, H, D) layout
        a = {n: (x.reshape(2, 4, 5, D).transpose(1, 2).contiguous()
                 if n != "u" else x) for n, x in a.items()}
        if kind == "u_heads_4d":          # 8 rows divide G = 8, not H = 4
            a["u"] = torch.zeros((8, D))
        elif kind == "strided_4d":
            a["w"] = a["w"].transpose(1, 2).contiguous().transpose(1, 2)
        elif kind == "s0_rows_4d":        # the state must be (B, H, D, D)
            kw["s0"] = torch.zeros((8, D, D))
        elif kind == "mixed_4d":
            a["k"] = a["k"].reshape(2, 5, 4 * D)
    return list(a.values()), kw


@pytest.mark.parametrize("kind,exc", [
    ("float64", TypeError), ("shape", ValueError),
    ("unsupported_D", ValueError), ("u_rows", ValueError),
    ("empty_T", ValueError), ("strided", ValueError),
    ("s0_shape", ValueError), ("s_out_dtype", TypeError),
    ("u_heads_4d", ValueError), ("strided_4d", ValueError),
    ("s0_rows_4d", ValueError), ("mixed_4d", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    args, kw = _bad(kind)
    with pytest.raises(exc):
        wkv6(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,start", [(8, 37, "zero"), (8, 64, "nonzero"),
                                       (1, 37, "zero"), (160, 1, "nonzero"),
                                       (16, 300, "zero")])
def test_cuda_kernel_matches_plain_on_card(g, t, start):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(g * 1000 + t)
    r, k, v = (torch.as_tensor(rng.standard_normal((g, t, D)),
                               dtype=torch.float32, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(-6 + torch.as_tensor(
        rng.standard_normal((g, t, D)), dtype=torch.float32,
        device="cuda")))
    u = torch.as_tensor(rng.standard_normal((min(g, 4), D)) / 2,
                        dtype=torch.float32, device="cuda")
    s0 = (torch.as_tensor(rng.standard_normal((g, D, D)),
                          dtype=torch.float32, device="cuda")
          if start == "nonzero" else None)
    before = launch_count()
    y, s = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0)
    m_y, m_s = magnitude(r, k, v, w, u, s0)
    assert float((y - y_p).abs().max()) <= RTOL * m_y
    assert float((s - s_p).abs().max()) <= RTOL * m_s
    if s0 is not None:                          # in place on the card too
        state = s0.clone()
        wkv6(r, k, v, w, u, state, s_out=state)
        torch.cuda.synchronize()
        assert torch.equal(state, s)


def _card_case(g, t, decay, seed):
    """Inputs on the card for one partition-crossing case: (B, H) with
    B * H = G, r, k, v standard normal, decays in the model's regime
    (about 0.9975) or small (``exp(-exp(noise))``, median 0.37), a
    per-head u and a start state."""
    b, h = {1: (1, 1), 3: (1, 3), 160: (4, 40)}[g]
    rng = np.random.default_rng([g, t, seed])

    def n(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device="cuda")

    r, k, v = n(b, t, h, D), n(b, t, h, D), n(b, t, h, D)
    shift = -6.0 if decay == "model" else 0.0
    w = torch.exp(-torch.exp(shift + n(b, t, h, D)))
    return r, k, v, w, n(h, D) / 2, n(b, h, D, D)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["model", "small"])
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("layout", ["rows", "bthd"])
@pytest.mark.parametrize("t", [1, 31, 37, 300, 512])
@pytest.mark.parametrize("g", [1, 3, 160])
def test_cuda_kernel_partition_shapes_match_plain(g, t, layout, start,
                                                  decay):
    """One row and several, T under, across and at chunk multiples, the
    (G, T, D) rows and the (B, T, H, D) layout: y and S_T within 1e-6 x M
    of the plain version on the card; both layouts equal to the bit; the
    in-place update (``s_out`` aliasing ``s0``) equal to the bit to the
    out-of-place one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    r, k, v, w, u, s_in = _card_case(g, t, decay, seed=7)
    s0 = s_in if start == "nonzero" else None
    b, h = r.shape[0], r.shape[2]

    def rows(x):
        return x.permute(0, 2, 1, 3).reshape(g, t, D).contiguous()

    args4 = (r, k, v, w, u, s0)
    args3 = (*(rows(x) for x in (r, k, v, w)), u,
             None if s0 is None else s0.reshape(g, D, D))
    args = args4 if layout == "bthd" else args3
    before = launch_count()
    y, s = wkv6(*args)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    y_p, s_p = wkv6_plain(*args)
    m_y, m_s = magnitude(*args)
    assert float((y - y_p).abs().max()) <= RTOL * m_y
    assert float((s - s_p).abs().max()) <= RTOL * m_s
    other = args3 if layout == "bthd" else args4
    y_o, s_o = wkv6(*other)
    if layout == "bthd":
        y_o, s_o = y_o.reshape(b, h, t, D).permute(0, 2, 1, 3), \
            s_o.reshape(b, h, D, D)
    else:
        y_o, s_o = rows(y_o), s_o.reshape(g, D, D)
    assert torch.equal(y, y_o) and torch.equal(s, s_o)
    if s0 is not None:
        state = args[5].clone()
        y_i, s_i = wkv6(*args[:5], state, s_out=state)
        torch.cuda.synchronize()
        assert s_i.data_ptr() == state.data_ptr()
        assert torch.equal(state, s) and torch.equal(y_i, y)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_misaligned_inputs():
    """The kernel copies r, k, v, w in 16-byte pieces; a view that starts
    off that grid is refused, not read wrongly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    r, k, v, w, u, _ = _card_case(3, 37, "model", seed=8)
    flat = torch.zeros(r.numel() + 1, device="cuda")
    shifted = flat[1:].view(r.shape)
    shifted.copy_(r)
    with pytest.raises(ValueError):
        wkv6(shifted, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "s0"])
def test_cuda_gradients_equal_plain_autograd_on_card(start):
    """The autograd node on the card (forward: the kernel; backward: the
    plain recompute) against autograd through the plain version on the
    card, within 1e-5 of each gradient's max |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    inputs = _card_case(3, 37, "model", seed=9)
    args = [x.requires_grad_() for x in inputs[:6 if start == "s0" else 5]]
    r = args[0]
    gy = torch.randn_like(r)
    gs = torch.randn(r.shape[0], r.shape[2], D, D, device="cuda")
    before = launch_count()
    got = torch.autograd.grad(wkv6(*args), args, (gy, gs))
    assert launch_count() == before + 1
    want = torch.autograd.grad(wkv6_plain(*args), args, (gy, gs))
    for g, p in zip(got, want):
        assert float((g - p).abs().max()) <= 1e-5 * float(p.abs().max())
