"""Counted work on the CPU: the counter (``analysis/counting.py``), the
step builders (``launch/steps.py``), the meshes (``launch/mesh.py``),
the one-card dry-run (``launch/dryrun.py``) and the hand-counted step
bounds (``analysis/roofline.py``).

- For a reduced config of every family and every shape kind, the count
  of a step built on ``meta`` equals the count of the same step run on
  the CPU with data: FLOPs and bytes to the unit; for MoE, FLOPs at a
  capacity that drops nothing and bytes no more than meta's (meta reads
  every expert a share of the pairs reaches, a real routing may leave
  some idle).
- The full-depth count (FLOPs, bytes, output bytes and the peak of live
  bytes) equals the dry-run's extrapolation from the two depths of
  ``count_depths`` within 1e-12.
- ``wkv6`` and ``rglru`` count by their formula alone on meta and the
  CPU (and on cuda, in the test marked for the card); their backwards
  count what they run.
- The dry-run CLI writes ``ok`` and ``skipped`` records, on one card
  and on the production meshes (a fake process group of 256 or 512
  ranks; reduced dense, MoE and rwkv6 cells): a record's parameter
  bytes per device equal the local shard bytes of the reference's
  ``param_specs`` on the same mesh shape.
- ``lm_step_bound``, ``dense_serve_bound`` and ``moe_serve_bound`` equal
  their terms summed by hand here from each config's widths.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline
from repro_torch.analysis.counting import OpCounter
from repro_torch.configs import ShapeCell, get_config
from repro_torch.kernels import _build
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch import (
    axis_size,
    data_axes,
    dryrun,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import (
    build_cell,
    eval_step,
    model_shape_specs,
    prefill_step,
    serve_step,
    train_step,
)
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import LM, init_cache, init_model
from repro_torch.optim import adamw
from test_torch_support import SRC

FP32 = DTypePolicy()
FAMILIES = ("smollm-135m", "internvl2-26b", "hubert-xlarge",
            "deepseek-v2-236b", "llama4-maverick-400b-a17b", "rwkv6-3b",
            "recurrentgemma-9b")
SHAPE = {"train": ShapeCell("t", "train", 40, 2),
         "prefill": ShapeCell("p", "prefill", 40, 2),
         "decode": ShapeCell("d", "decode", 48, 2)}
CASES = [(a, k) for a in FAMILIES for k in SHAPE
         if not (k == "decode" and get_config(a).encoder_only)]


def _reduced(arch: str, **changes):
    """The reduced config; a MoE one at a capacity factor of E, so the
    capacity (T k / E x E + 1) drops no pair."""
    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return dataclasses.replace(cfg, **changes)


def _cpu_cell(cfg, shape: ShapeCell, policy=FP32, seed: int = 0):
    """(fn, args, static) of the step ``build_cell`` builds for
    ``shape``, with data on the CPU: weights drawn from ``seed``, tokens
    and frame embeddings from numpy."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len

    def ints(*size):
        return torch.as_tensor(rng.integers(0, cfg.vocab, size),
                               dtype=torch.int32)

    def emb(*size):
        return torch.as_tensor(rng.standard_normal(size + (cfg.d_model,)),
                               dtype=torch.bfloat16)

    def batch(labels: bool):
        if cfg.family == "audio":
            out = {"embeds": emb(b, s), "labels": ints(b, s)}
        elif cfg.family == "vlm":
            p = cfg.frontend_prefix
            out = {"embeds": emb(b, p), "tokens": ints(b, s - p),
                   "labels": ints(b, s - p)}
        else:
            out = {"tokens": ints(b, s), "labels": ints(b, s)}
        if not labels:
            out.pop("labels")
        return out

    trains = shape.kind == "train"
    model = init_model(cfg, policy, seed=seed, torch_device="cpu",
                       trainable=trains)
    if trains:
        fn = dryrun_train_fn()
        return fn, (model, adamw.init(dict(model.named_parameters())),
                    batch(True)), {}
    if shape.kind == "decode":
        cache = init_cache(cfg, b, s, policy, torch_device="cpu")
        length = torch.full((b,), s - 8, dtype=torch.int32)
        return serve_step, (model, cache, ints(b), length), {}
    if cfg.encoder_only:
        return eval_step, (model, batch(False)), {}
    return prefill_step, (model, batch(False)), {"cache_len": s}


def dryrun_train_fn():
    """The train step ``build_train_step`` binds: AdamW's defaults,
    remat on."""
    import functools

    return functools.partial(train_step, opt_cfg=adamw.AdamWConfig(),
                             remat=True)


def _meta_count(cfg, shape, policy=FP32):
    fn, args, in_sh, out_sh, static = build_cell(cfg, shape, None, policy)
    assert in_sh is None and out_sh is None
    return dryrun.count_step(fn, args, static, "meta")


# ---------------------------------------------------------------------------
# meta against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", CASES)
def test_meta_count_equals_cpu_count(arch, kind):
    cfg = _reduced(arch)
    meta = _meta_count(cfg, SHAPE[kind])
    fn, args, static = _cpu_cell(cfg, SHAPE[kind])
    cpu = dryrun.count_step(fn, args, static, "cpu")
    assert cpu["flops"] == meta["flops"] > 0
    if cfg.moe:
        assert 0 < cpu["bytes"] <= meta["bytes"]
    else:
        assert cpu["bytes"] == meta["bytes"] > 0
    assert cpu["kernels"] == meta["kernels"]
    assert cpu["collectives"] == meta["collectives"] == {"total": 0.0}
    assert cpu["output"] == meta["output"] > 0


def test_meta_count_equals_cpu_count_in_bf16():
    cfg = _reduced("qwen3-8b")
    bf16 = DTypePolicy.bf16()
    for kind in ("train", "decode"):
        meta = _meta_count(cfg, SHAPE[kind], bf16)
        fn, args, static = _cpu_cell(cfg, SHAPE[kind], bf16)
        cpu = dryrun.count_step(fn, args, static, "cpu")
        assert (cpu["flops"], cpu["bytes"]) == (meta["flops"], meta["bytes"])


def test_meta_moe_routes_every_pair_evenly():
    """On meta every (token, k) pair counts as routed, none dropped, the
    pairs spread as evenly as whole pairs go over the experts; with data
    the run starts come from the routing."""
    from repro_torch.models.moe import _run_starts

    meta = torch.empty(9, dtype=torch.int64, device="meta")
    assert _run_starts(meta, 12, 8) == [0, 1, 3, 4, 6, 7, 9, 10, 12]
    assert _run_starts(meta, 3, 8) == [0, 0, 0, 1, 1, 1, 2, 2, 3]
    real = torch.tensor([0, 0, 5, 5, 5, 6, 6, 6, 6])
    assert _run_starts(real, 6, 8) == real.tolist()


# ---------------------------------------------------------------------------
# depth extrapolation
# ---------------------------------------------------------------------------

# every family 4 or 5 repeat units deep: past the deeper counted depth (3)
DEEPER = {"smollm-135m": dict(n_layers=5),
          "deepseek-v2-236b": dict(n_layers=5),        # 1 dense + 4 MoE
          "llama4-maverick-400b-a17b": dict(n_layers=8),   # 4 groups
          "rwkv6-3b": dict(n_layers=5),
          "recurrentgemma-9b": dict(n_layers=14)}      # 4 groups + 2 tail


@pytest.mark.parametrize("arch", DEEPER)
@pytest.mark.parametrize("kind", ("train", "decode"))
def test_full_depth_count_equals_extrapolation(arch, kind):
    cfg = _reduced(arch, **DEEPER[arch])
    got, _, (lo, hi, full) = dryrun.count_extrapolated(cfg, SHAPE[kind],
                                                       policy=FP32)
    assert (lo, hi) == (2, 3) and full > hi
    want = _meta_count(cfg, SHAPE[kind])
    for key in ("flops", "bytes", "output", "temp"):
        assert abs(got[key] - want[key]) <= 1e-12 * want[key], key


# ---------------------------------------------------------------------------
# the recurrences' kernels: counted by formula
# ---------------------------------------------------------------------------


def _wkv6_inputs(device, grad=False):
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        x = torch.as_tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=device)
        return x.requires_grad_(grad)

    r, k, v = t(2, 5, 2, 64), t(2, 5, 2, 64), t(2, 5, 2, 64)
    w = torch.full((2, 5, 2, 64), 0.9, device=device).requires_grad_(grad)
    return r, k, v, w, t(2, 64, scale=0.1), t(2, 2, 64, 64)


def _rglru_inputs(device, grad=False):
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.as_tensor(rng.uniform(0.1, 0.9, shape),
                               dtype=torch.float32,
                               device=device).requires_grad_(grad)

    return t(2, 7, 24), t(2, 7, 24), t(2, 24)


def _check_formula_counts(device):
    r, k, v, w, u, s0 = _wkv6_inputs(device)
    a, b, h0 = _rglru_inputs(device)
    launches = (wkv6_ops.launch_count(), rglru_ops.launch_count())
    with OpCounter(device) as c:
        y, s = wkv6_ops.wkv6(r, k, v, w, u, s0)
        h, h_t = rglru_ops.rglru(a, b, h0, h_out=h0)
    ops_w, bytes_w = wkv6_ops.work(r, u, s0)
    ops_r, bytes_r = rglru_ops.work(a, h0)
    assert (c.flops, c.bytes) == (ops_w + ops_r, bytes_w + bytes_r)
    assert not c.by_op                  # no aten op of the wrappers counted
    assert c.summary()["kernels"] == {
        "wkv6": dict(calls=1, ops=ops_w, bytes=bytes_w),
        "rglru": dict(calls=1, ops=ops_r, bytes=bytes_r)}
    assert y.shape == r.shape and s.shape == s0.shape
    assert h.shape == a.shape and h_t is h0
    return launches, (wkv6_ops.launch_count(), rglru_ops.launch_count())


@pytest.mark.parametrize("device", ("cpu", "meta"))
def test_recurrence_kernels_count_by_formula(device):
    before, after = _check_formula_counts(device)
    assert after == before             # nothing launches off the card


@pytest.mark.cuda
def test_recurrence_kernels_count_by_formula_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before, after = _check_formula_counts("cuda")
    assert after == (before[0] + 1, before[1] + 1)


def test_recurrence_formulas():
    r = torch.empty((3, 11, 4, 64), device="meta")
    u = torch.empty((4, 64), device="meta")
    g, t, d = 12, 11, 64
    assert wkv6_ops.work(r, u) == (g * t * (5 * d * d + 5 * d),
                                   4 * (5 * g * t * d + 4 * d + g * d * d))
    assert wkv6_ops.work(r, u, torch.empty(3, 4, 64, 64))[1] == \
        4 * (5 * g * t * d + 4 * d + 2 * g * d * d)
    a = torch.empty((2, 9, 5))
    assert rglru_ops.work(a) == (2 * 90, 4 * (3 * 90 + 10))
    assert rglru_ops.work(a, torch.empty(2, 5)) == (180, 4 * (270 + 20))


@pytest.mark.parametrize("device", ("cpu", "meta"))
def test_recurrence_backwards_count_what_they_run(device):
    """``rglru``'s backward is a second formula-counted call (the
    reverse launch) plus the aten ops around it; ``wkv6``'s is the plain
    recompute, counted by its aten ops."""
    r, k, v, w, u, s0 = _wkv6_inputs(device, grad=True)
    a, b, h0 = _rglru_inputs(device, grad=True)
    with OpCounter(device) as c:
        y, s = wkv6_ops.wkv6(r, k, v, w, u, s0)
        h, h_t = rglru_ops.rglru(a, b, h0)
        forward = dict(c.by_op)
        torch.autograd.grad((y.sum() + s.sum() + h.sum() + h_t.sum()),
                            (r, k, v, w, u, s0, a, b, h0))
    kernels = c.summary()["kernels"]
    assert kernels["wkv6"]["calls"] == 1 and kernels["rglru"]["calls"] == 2
    assert kernels["rglru"]["ops"] == 2 * rglru_ops.work(a, h0)[0]
    grown = {k for k, v in c.by_op.items() if forward.get(k) != v}
    assert {"aten.mul", "aten.sum"} <= grown      # the recompute and dA
    assert "aten.flip" in grown                   # around the reverse call


# ---------------------------------------------------------------------------
# the counter's rules
# ---------------------------------------------------------------------------


def test_counter_rules():
    a = torch.ones(6, 4)
    b = torch.ones(4, 5)
    with OpCounter("cpu") as c:
        m = a @ b                              # 2 m n k, 4 (24 + 20 + 30)
        v = m.view(30)                         # a view: 0
        v.mul_(2.0)                            # in place: in and out
        e = torch.empty(1000)                  # an allocation: 0
        with _build.counted("k", 7, 11):
            (a * 3).sum()                      # hidden
    assert c.flops == 2 * 6 * 4 * 5 + 7
    assert c.bytes == 4 * (24 + 20 + 30) + 4 * (30 + 30) + 11
    assert c.by_op["aten.view"] == [1, 0, 0]
    assert c.by_op["aten.empty"] == [1, 0, 0]
    assert c.kernels["k"] == [1, 7, 11]
    assert c.peak_bytes >= 4 * (30 + 1000) and e.numel() == 1000
    assert not _build.COUNTERS                 # the hook list is left empty


def test_counter_rules_for_writes_into_an_argument():
    """An op that writes into an argument counts its other inputs plus
    what it writes: an indexed write the elements it writes (twice where
    it adds into them), an overwrite the destination once, any other
    in-place op the destination read and written."""
    cache = torch.zeros(4, 8, 3)
    rows = torch.arange(2)
    pos = torch.tensor([5, 6])
    vals = torch.ones(2, 3)
    src = torch.ones(4, 3)
    mask = torch.zeros(4, 8, dtype=torch.bool)
    with OpCounter("cpu") as c:
        cache[rows, pos] = vals                # the decode cache's write
        n_put = c.bytes
        cache.index_put_((rows, pos), vals, accumulate=True)
        n_add = c.bytes - n_put
        cache[:, 2].copy_(src)                 # a view, then an overwrite
        n_copy = c.bytes - n_put - n_add
        cache.fill_(0.5)
        n_fill = c.bytes - n_put - n_add - n_copy
        cache.index_copy_(1, pos, torch.ones(4, 2, 3))
        n_index_copy = c.bytes - n_put - n_add - n_copy - n_fill
        cache[mask] = 2.0                      # a mask: all it covers
        n_mask = c.bytes - n_put - n_add - n_copy - n_fill - n_index_copy
    index = 2 * 2 * 8                          # rows and pos, int64
    assert n_put == index + 4 * 6 + 4 * 6
    assert n_add == index + 4 * 6 + 2 * 4 * 6
    assert n_copy == 4 * 12 + 4 * 12
    assert n_fill == 4 * 96
    assert c.by_op["aten.ones"][2] == 4 * 24   # the source index_copy_ reads
    assert n_index_copy == 4 * 24 + 2 * 8 + 4 * 24 + 4 * 24
    assert c.by_op["aten.index_put_"][0] == 3
    assert n_mask == 4 * 8 + 4 + 4 * 96        # mask, value, 32 x 3 written
    assert float(cache[0, 5, 0]) == 1.0 and float(cache[0, 0, 0]) == 0.5


def test_counter_ignores_other_devices_and_tracks_live_bytes():
    with OpCounter("meta") as c:
        torch.ones(10).add(1)                  # a CPU op: not counted
        x = torch.empty(100, device="meta") + 1
        y = x * 2
        del x
        z = y * 2
    assert c.flops == 0 and c.by_op["aten.add"][0] == 1
    assert c.peak_bytes == 2 * 400 and c.live_bytes == 2 * 400
    assert z.shape == (100,)


# ---------------------------------------------------------------------------
# builders, meshes and the dry-run
# ---------------------------------------------------------------------------


def test_model_shape_specs_draw_nothing():
    cfg = get_config("llama4-maverick-400b-a17b")       # 795 GB in bf16
    model = model_shape_specs(cfg)
    assert isinstance(model, LM)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert model.embed.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) > 3.9e11


def test_meshes():
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_device

    one = make_host_mesh(torch_device="cpu")
    assert one.axis_names == ("data", "model") and one.size == 1
    assert axis_size(one, "data", "model") == 1
    assert mesh_device(one) == torch.device("cpu")
    cfg = _reduced("smollm-135m")
    fn, args, in_sh, out_sh, static = build_cell(cfg, SHAPE["prefill"], one)
    assert static == {"cache_len": 40} and in_sh is None
    assert not dist.is_initialized()
    for multi, size in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi)
        try:
            assert mesh.size() == size and dist.get_backend() == "fake"
            assert data_axes(mesh) == (("pod", "data") if multi
                                       else ("data",))
            assert axis_size(mesh, "pod", "data") == (32 if multi else 16)
            assert axis_size(mesh, "model", "absent") == 16
            assert mesh_device(mesh) == torch.device("meta")
            if not multi:   # a cell on the mesh: placements, not None
                fn, args, in_sh, out_sh, _ = build_cell(
                    cfg, SHAPE["decode"], mesh)
                assert in_sh[0]["embed"][1].is_shard()    # vocab, model
                out = dryrun.count_step(fn, args, {}, "meta")
                assert out["flops"] > 0 and out["collectives"]
        finally:
            dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


def test_dryrun_cli_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced())
    out = tmp_path / "report.json"
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--arch", "smollm-135m", "--shape", shape,
                            "--out", str(out), "--append"]) == 0
    recs = {r["shape"]: r for r in json.loads(out.read_text())}
    ok, skipped = recs["decode_32k"], recs["long_500k"]
    assert skipped["status"] == "skipped"
    assert ok["status"] == "ok" and ok["chips"] == 1 and ok["mesh"] == "one"
    assert ok["depth_extrapolation"] == [1, 2, 2]
    assert ok["flops"] == ok["flops_raw"] > 0           # full depth is d2
    assert ok["argument_size_in_bytes"] > 0 and ok["temp_size_in_bytes"] > 0
    assert ok["fits_one_card"] is True
    r = roofline.from_record(ok, get_config("smollm-135m").reduced(),
                             dryrun.get_shape("decode_32k"), roofline.H100,
                             roofline.H100.bf16_flops)
    assert r.chips == 1 and r.step_time_lb > 0


def test_dryrun_cell_that_does_not_fit_is_ok():
    rec = dryrun.run_cell("deepseek-v2-236b", "decode_32k", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fits_one_card"] is False
    assert rec["argument_size_in_bytes"] > 4.7e11          # bf16 weights
    assert rec["depth_extrapolation"] == [2, 3, 59]      # MoE layers


PARAM_BYTES_REF = """
import json
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models.common import DTypePolicy
from repro.models.transformer import init_model


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


meshes = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}
policy = DTypePolicy(jnp.bfloat16, jnp.bfloat16)
res = {}
for arch in ("smollm-135m", "deepseek-v2-236b", "rwkv6-3b"):
    cfg = get_config(arch).reduced()
    params = jax.eval_shape(
        lambda: init_model(jax.random.PRNGKey(0), cfg, policy))
    leaves = jax.tree_util.tree_leaves(params)
    for name, mesh in meshes.items():
        specs = jax.tree_util.tree_leaves(
            shd.param_specs(params, mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        total = 0
        for leaf, spec in zip(leaves, specs):
            n = leaf.size * leaf.dtype.itemsize
            for e in spec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n //= mesh.shape[a]
            total += n
        res[f"{arch}/{name}"] = total
out["json"] = np.array(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_param_bytes(tmp_path_factory):
    from test_torch_support import run_reference

    got = run_reference(PARAM_BYTES_REF, None,
                        tmp_path_factory.mktemp("ref_param_bytes"))
    return json.loads(str(got["json"]))


def _mesh_records(tmp_path, monkeypatch, mesh, arch, shape):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced())
    out = tmp_path / f"{mesh}.json"
    assert dryrun.main(["--mesh", mesh, "--arch", arch, "--shape", shape,
                        "--out", str(out)]) == 0
    import torch.distributed as dist

    assert not dist.is_initialized()       # the fake group is gone
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,shape", (("smollm-135m", "train_4k"),
                                        ("deepseek-v2-236b", "train_4k"),
                                        ("rwkv6-3b", "prefill_32k")))
def test_dryrun_single_mesh_records(tmp_path, monkeypatch, ref_param_bytes,
                                    arch, shape):
    (rec,) = _mesh_records(tmp_path, monkeypatch, "single", arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "single" and rec["chips"] == 256
    assert rec["param_size_in_bytes"] == ref_param_bytes[f"{arch}/single"]
    assert 0 < rec["param_size_in_bytes"] < rec["argument_size_in_bytes"]
    assert rec["flops"] > 0 and rec["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total"] > 0


@pytest.mark.parametrize("mesh", ("single", "multi", "both"))
def test_dryrun_refuses_production_meshes(mesh, tmp_path, monkeypatch,
                                          ref_param_bytes):
    """The production meshes are no longer refused: each gives ``ok``
    records, one rank's share, per mesh it names."""
    recs = _mesh_records(tmp_path, monkeypatch, mesh, "smollm-135m",
                         "decode_32k")
    names = ("single", "multi") if mesh == "both" else (mesh,)
    assert [r["mesh"] for r in recs] == list(names)
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["param_size_in_bytes"] == \
            ref_param_bytes[f"smollm-135m/{r['mesh']}"]


def test_importing_dryrun_leaves_the_environment_alone():
    code = ("import os; env = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "assert dict(os.environ) == env")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the hand-counted step bounds, term by term
# ---------------------------------------------------------------------------

MS = 1e3


def _bound(nbytes, ops, rate):
    return max(nbytes / 3.35e12 * MS, ops / rate * MS)


def _meta_model(arch, policy=FP32):
    cfg = get_config(arch).reduced()
    return cfg, LM(cfg, policy, None, torch.device("meta"))


def _causal(s):
    return s * (s + 1) / 2


def test_dense_bounds_by_hand():
    cfg, model = _meta_model("smollm-135m")           # tied embeddings
    d, h, kv, dh, f, v, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_layers)
    layer_mm = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f
    layer = layer_mm + 2 * d
    params = v * d + d + n * layer
    b, s = 3, 20
    kv_bytes = n * 2 * b * s * kv * dh * 4
    attn = n * 2 * 2 * b * h * dh * _causal(s)
    got = roofline.dense_serve_bound(cfg, model, b, s)
    assert got["decode_bytes"] == params * 4 + kv_bytes
    assert got["decode_ops"] == 2 * params * b
    assert got["prefill_ops"] == 2 * n * layer * b * s + attn + 2 * v * d * b
    assert got["decode_bound_ms"] == _bound(params * 4 + kv_bytes,
                                            2 * params * b, 67e12)
    train = roofline.lm_step_bound(cfg, model, b, s, train=True)
    ops = 3 * (2 * (v * d + n * layer_mm) * b * s + attn)
    assert (train["bound_ops"], train["bound_bytes"]) == (ops, 6 * params * 4)
    assert train["bound_ms"] == _bound(6 * params * 4, ops, 67e12)
    fwd = roofline.lm_step_bound(cfg, model, b, s, train=False)
    assert fwd["bound_ops"] == ops / 3
    assert fwd["bound_bytes"] == params * 4 + b * s * v * 4


def test_moe_bounds_by_hand():
    cfg, model = _meta_model("deepseek-v2-236b", DTypePolicy.bf16())
    d, h, v, n, e, k = (cfg.d_model, cfg.n_heads, cfg.vocab, cfg.n_layers,
                        cfg.n_experts, cfg.top_k)
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q, r = cfg.q_lora_rank, cfg.kv_lora_rank
    attn_mm = (d * q + q * h * (nope + rope) + d * (r + rope)
               + r * h * nope + r * h * vh + h * vh * d)
    attn = attn_mm + r + q                           # kv_norm, q_norm
    n_moe, n_dense = cfg.moe_layout()
    dense = attn + 3 * d * cfg.dense_d_ff + 2 * d
    shared = 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
    expert = 3 * d * cfg.moe_d_ff
    moe_base = attn + d * e + shared + 2 * d
    base = n_dense * dense + n_moe * moe_base + d + d * v    # norm, head
    b, s, routed = 2, 12, [3]
    cache = n * b * s * (r + rope) * 2
    active = base + n_moe * k * expert
    got = roofline.moe_serve_bound(cfg, model, b, s, routed)
    assert got["active_params_per_token"] == active
    base_bytes = base * 2 + n_moe * d * e * 2      # the router is float32
    assert got["decode_bytes"] == (base_bytes + b * d * 2 + 3 * expert * 2
                                   + cache)
    assert got["decode_all_experts_bytes"] == (base_bytes + b * d * 2
                                               + n_moe * e * expert * 2
                                               + cache)
    attn_ops = n * 2 * b * h * (nope + rope + vh) * _causal(s)
    assert got["prefill_ops"] == (2 * (active - d * v - d) * b * s + attn_ops
                                  + 2 * d * v * b)
    assert got["decode_bound_ms"] == _bound(got["decode_bytes"],
                                            2 * active * b, 989e12)
    train = roofline.lm_step_bound(cfg, model, b, s, train=True)
    mm = d * v + n_dense * (attn_mm + 3 * d * cfg.dense_d_ff) \
        + n_moe * (attn_mm + d * e + shared)
    ops = 3 * (2 * mm * b * s + 2 * expert * b * s * k * n_moe + attn_ops)
    params = base + n_moe * e * expert + v * d
    assert (train["bound_ops"], train["bound_bytes"]) == (ops, 6 * params * 4)


def test_ssm_and_hybrid_bounds_by_hand():
    cfg, model = _meta_model("rwkv6-3b")
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    lora = 32
    tm_mm = d * 5 * lora + 5 * lora * d + 5 * d * d + 2 * d * 2 * lora
    cm_mm = 2 * d * f + d * d
    heads = d // 64
    b, s = 2, 9
    ops = (2 * (d * v + n * (tm_mm + cm_mm)) * b * s
           + n * b * s * heads * (5 * 64 * 64 + 5 * 64))
    got = roofline.lm_step_bound(cfg, model, b, s, train=False)
    assert got["bound_ops"] == ops

    cfg, model = _meta_model("recurrentgemma-9b")
    d, f, w, h, kv, dh = (cfg.d_model, cfg.d_ff, cfg.rg_lru_width,
                          cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    rg_mm = 2 * d * w + 2 * 16 * (w // 16) ** 2 + w * d + 3 * d * f
    attn_mm = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f
    b, s, win = 2, 40, cfg.local_window
    pairs = _causal(win) + (s - win) * win
    ops = 3 * (2 * (d * cfg.vocab + 2 * rg_mm + attn_mm) * b * s
               + 2 * 2 * b * h * dh * pairs + 2 * 2 * b * s * w)
    got = roofline.lm_step_bound(cfg, model, b, s, train=True)
    assert got["bound_ops"] == ops
