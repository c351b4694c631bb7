"""The port's flash-attention backward against ``jax.vjp`` of the
reference's ``chunked_attention`` (its ``_flash`` custom VJP).

Each case draws q (B, S, KV, G, Dh), k, v (B, S, KV, Dh) and the output
cotangent with numpy from a seed, then compares the forward output and
the three gradients: causal, non-causal, a sliding window, S not a
multiple of either chunk, and G = 2 and 3 query heads a KV head, in
float32, and two cases in bfloat16.

Tolerance: float32 1e-5 of the reference's max |value| per tensor (both
sides accumulate every product in float32 and differ in summation order
only; measured on the CPU: at most 4.9e-7). bfloat16 2^-7 of max
|value|, one bf16 step at the largest element: both sides round the
probabilities and ``ds`` to bfloat16 before their products and each
gradient to bfloat16 at the end, so a float32 sum that lands on the
other side of a rounding boundary moves an element by one bf16 step
(measured on the CPU: at most 2.4e-7, one element of one case).

The reference sweeps every KV chunk in its backward; the port skips the
chunks its forward skips (after a Q chunk's last row when causal, before
its window). A skipped chunk's probabilities are exactly 0, so the
skipping changes no bit: the last test runs the port with the skipping
turned off and requires equal gradients.
"""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.models import attention as attn_mod

B, KV, DH = 2, 2, 16
CASES = {  # name: (S, G, causal, window, q_chunk, kv_chunk, dtype)
    "causal": (32, 1, True, None, 8, 16, "float32"),
    "noncausal_ragged": (37, 2, False, None, 8, 16, "float32"),
    "window": (40, 2, True, 7, 8, 8, "float32"),
    "causal_ragged_g3": (37, 3, True, None, 16, 8, "float32"),
    "noncausal_one_chunk": (12, 2, False, None, 512, 1024, "float32"),
    "bf16_causal": (37, 2, True, None, 8, 16, "bfloat16"),
    "bf16_window": (40, 2, True, 7, 8, 8, "bfloat16"),
}
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs():
    rng = np.random.default_rng(7)
    inp = {}
    for name, (s, g, *_rest) in CASES.items():
        inp[f"{name}/q"] = rng.standard_normal((B, s, KV, g, DH))
        inp[f"{name}/k"] = rng.standard_normal((B, s, KV, DH))
        inp[f"{name}/v"] = rng.standard_normal((B, s, KV, DH))
        inp[f"{name}/do"] = rng.standard_normal((B, s, KV, g, DH))
    return {k: v.astype(np.float32) for k, v in inp.items()}


REF = """
import jax.numpy as jnp
from repro.models.attention import chunked_attention

for name, (s, g, causal, window, qc, kc, dt) in CASES.items():
    dt = jnp.dtype(dt)
    q, k, v, do = (jnp.asarray(inp[f"{name}/{x}"]).astype(dt)
                   for x in ("q", "k", "v", "do"))
    f = lambda q, k, v: chunked_attention(q, k, v, causal=causal,
                                          window=window, q_chunk=qc,
                                          kv_chunk=kc)
    o, vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp(do)
    for tag, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        out[f"{name}/{tag}"] = np.asarray(x.astype(jnp.float32))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(f"CASES = {CASES!r}\n" + REF, _inputs(),
                         tmp_path_factory.mktemp("ref_flash_bwd"))


def _port(name, inp):
    s, g, causal, window, qc, kc, dt = CASES[name]
    dt = getattr(torch, dt)
    q, k, v = (torch.tensor(inp[f"{name}/{x}"]).to(dt).requires_grad_()
               for x in ("q", "k", "v"))
    o = attn_mod.chunked_attention(q, k, v, causal=causal, window=window,
                                   q_chunk=qc, kv_chunk=kc)
    grads = torch.autograd.grad(o, (q, k, v),
                                torch.tensor(inp[f"{name}/do"]).to(dt))
    return dict(zip(("o", "dq", "dk", "dv"), (o.detach(),) + grads))


def _close(got, want, what, rtol):
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs err {err} > {rtol} x {scale}"


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_reference(ref, name):
    got = _port(name, _inputs())
    dt = CASES[name][-1]
    for tag, x in got.items():
        assert x.dtype == getattr(torch, dt), (tag, x.dtype)
        _close(x, ref[f"{name}/{tag}"], f"{name} {tag}", RTOL[dt])


def test_no_grad_runs_the_forward_alone(monkeypatch):
    """Without grad the Function is not entered, and the output is the
    Function's to the bit."""
    inp = _inputs()
    calls = []
    monkeypatch.setattr(attn_mod._Flash, "apply",
                        lambda *a: calls.append(1) or
                        attn_mod._flash_fwd(*a[:7], with_lse=True)[0])
    q, k, v = (torch.tensor(inp[f"window/{x}"]) for x in ("q", "k", "v"))
    with torch.no_grad():
        plain = attn_mod.chunked_attention(q, k, v, causal=True, window=7,
                                           q_chunk=8, kv_chunk=8)
    assert not calls
    monkeypatch.undo()
    graded = _port("window", inp)["o"]
    assert torch.equal(plain, graded)


@pytest.mark.parametrize("name", ["causal", "window", "causal_ragged_g3"])
def test_skipped_chunks_add_exact_zeros(monkeypatch, name):
    inp = _inputs()
    skipping = _port(name, inp)
    nkv_of = {}

    def full_range(qi, q_chunk, kv_chunk, nkv, causal, window):
        nkv_of[qi] = nkv
        return 0, nkv

    monkeypatch.setattr(attn_mod, "_kv_range", full_range)
    sweeping = _port(name, inp)
    assert nkv_of and max(nkv_of.values()) > 1
    for tag in ("o", "dq", "dk", "dv"):
        assert torch.equal(skipping[tag], sweeping[tag]), tag
