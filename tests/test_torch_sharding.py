"""The sharding rules of ``repro_torch.distributed`` against the JAX
package's, and the scenario mesh.

- ``fit_spec``, ``param_specs``, ``param_specs_serving``,
  ``cache_specs`` and ``batch_specs`` equal the reference's leaf for
  leaf, for every architecture at full shape (the reference from
  ``jax.eval_shape``, the port on ``meta``), on the reference test's
  16 x 16 and 2 x 16 x 16 stand-in meshes (no devices); a per-layer
  tensor's spec is its stacked leaf's without the layer entry.
- ``placements`` turns a spec into DTensor placements.
- ``scenario_mesh`` without a process group is the run's one device;
  ``shard_scenarios`` keeps rank r's block of rows when the ranks divide
  the scenario count, every row otherwise.
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import scenario_mesh, shard_scenarios
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import init_cache, init_model
from test_torch_support import run_reference


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"mesh2": FakeMesh({"data": 16, "model": 16}),
          "mesh3": FakeMesh({"pod": 2, "data": 16, "model": 16})}
CACHE_CELL = ("decode_32k", 128, 32_768)
BF16 = DTypePolicy.bf16()

# shapes drawn as test_fit_spec_always_legal draws them (1-4 dims of
# 1..4096), half of them from multiples of 16 so that axes divide
_rng = np.random.default_rng(7)
FIT_SHAPES = [
    [int(x) for x in (_rng.integers(1, 4097, size=_rng.integers(1, 5))
                      if i % 2 else
                      16 * _rng.integers(1, 257, size=_rng.integers(1, 5)))]
    for i in range(240)]


def _norm(spec, ndim):
    """A spec as a list of ndim entries (None, a name, or a tuple)."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]


REF_BODY = """
import json
import jax
import jax.numpy as jnp
from repro.configs import ARCH_NAMES, SHAPES, get_config
from repro.data.pipeline import make_batch_specs
from repro.distributed import sharding as shd
from repro.models.common import DTypePolicy
from repro.models.transformer import init_cache, init_model


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"mesh2": FakeMesh({"data": 16, "model": 16}),
          "mesh3": FakeMesh({"pod": 2, "data": 16, "model": 16})}
policy = DTypePolicy(jnp.bfloat16, jnp.bfloat16)


def named(tree, specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {shd._leaf_name(p): [list(e) if isinstance(e, tuple) else e
                                for e in s] + [None] * (len(l.shape) - len(s))
            for (p, l), s in zip(flat, sflat)}


res = {}
cell, b, t = json.loads(str(inp["cache_cell"]))
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    params = jax.eval_shape(
        lambda: init_model(jax.random.PRNGKey(0), cfg, policy))
    cache = None
    if not cfg.encoder_only:
        cache = jax.eval_shape(lambda: init_cache(cfg, b, t, policy))
    for mname, mesh in MESHES.items():
        r = res.setdefault(arch, {}).setdefault(mname, {})
        r["params"] = named(params, shd.param_specs(params, mesh))
        r["serving"] = named(params, shd.param_specs_serving(params, mesh))
        if cache is not None:
            r["cache"] = named(cache, shd.cache_specs(cache, mesh))
        r["batch"] = {}
        for shape in SHAPES:
            bs = make_batch_specs(cfg, shape)
            r["batch"][shape.name] = named(bs, shd.batch_specs(bs, mesh))
fits = {}
for mname, mesh in MESHES.items():
    fits[mname] = []
    for s in json.loads(str(inp["fit_shapes"])):
        spec = shd.fit_spec(s, (shd.DATA, "model", "model", None)[:len(s)],
                            mesh)
        fits[mname].append([list(e) if isinstance(e, tuple) else e
                            for e in spec] + [None] * (len(s) - len(spec)))
out["json"] = np.array(json.dumps({"archs": res, "fits": fits}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    got = run_reference(
        REF_BODY, {"cache_cell": np.array(json.dumps(CACHE_CELL)),
                   "fit_shapes": np.array(json.dumps(FIT_SHAPES))},
        tmp_path_factory.mktemp("ref_sharding"), timeout=300)
    return json.loads(str(got["json"]))


def _port_params(arch):
    return init_model(get_config(arch), BF16, torch_device="meta")


def _against_stacked(port_specs, port_tensors, ref_specs):
    """Each port spec against its reference leaf's (the stacked leaf's
    without its layer entry); every reference leaf is reached."""
    reached = set()
    for name, spec in port_specs.items():
        rname, stacked = shd.reference_name(name)
        want = _norm(ref_specs[rname], len(port_tensors[name].shape)
                     + stacked)
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert _norm(spec, len(port_tensors[name].shape)) == want, name
        reached.add(rname)
    assert reached == set(ref_specs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(ref, arch, mesh):
    model = _port_params(arch)
    tensors = dict(model.named_parameters())
    r = ref["archs"][arch][mesh]
    _against_stacked(shd.param_specs(model, MESHES[mesh]), tensors,
                     r["params"])
    _against_stacked(shd.param_specs_serving(tensors, MESHES[mesh]),
                     tensors, r["serving"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_and_batch_specs_match_reference(ref, arch, mesh):
    cfg = get_config(arch)
    r = ref["archs"][arch][mesh]
    m = MESHES[mesh]
    if not cfg.encoder_only:
        _, b, t = CACHE_CELL
        cache = init_cache(cfg, b, t, BF16, torch_device="meta")
        got = {k: _norm(v, len(v))
               for k, v in shd.cache_reference_specs(cache, m).items()}
        assert got == {k: _norm(v, len(v)) for k, v in r["cache"].items()}
        # the per-layer specs are the stacked ones without the layer entry
        names = []
        shd._map_cache(cache, lambda t, rname, n: names.append(rname))
        pairs = list(_zip_cache(cache, shd.cache_specs(cache, m)))
        assert len(pairs) == len(names)
        for (t, spec), rname in zip(pairs, names):
            assert _norm(spec, t.dim()) == _norm(r["cache"][rname],
                                                 t.dim() + 1)[1:]
    for shape in SHAPES:
        batch = {k: torch.empty(s, dtype=dt, device="meta")
                 for k, (s, dt) in make_batch_specs(cfg, shape).items()}
        got = {k: _norm(v, len(batch[k].shape))
               for k, v in shd.batch_specs(batch, m).items()}
        want = {k: _norm(v, len(batch[k].shape))
                for k, v in r["batch"][shape.name].items()}
        assert got == want, shape.name


def _zip_cache(cache, specs):
    """(tensor, spec) pairs of a cache and its spec tree, walked by the
    cache's structure."""
    if isinstance(cache, torch.Tensor):
        yield cache, specs
    elif isinstance(cache, (list, tuple)):
        for c, s in zip(cache, specs):
            yield from _zip_cache(c, s)
    else:
        for k in cache:
            yield from _zip_cache(cache[k], specs[k])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_spec_matches_reference(ref, mesh):
    for shape, want in zip(FIT_SHAPES, ref["fits"][mesh]):
        got = shd.fit_spec(shape, (shd.DATA, "model", "model", None)
                           [:len(shape)], MESHES[mesh])
        assert _norm(got, len(shape)) == _norm(want, len(shape)), shape


@given(st.lists(st.integers(1, 4096), min_size=1, max_size=4))
@settings(max_examples=80, deadline=None)
def test_fit_spec_always_legal(shape):
    """Every produced spec only shards dims it divides, and never reuses
    a mesh axis (the reference test's property, on the port)."""
    mesh3 = MESHES["mesh3"]
    spec = shd.fit_spec(shape, (shd.DATA, "model", "model", None)
                        [:len(shape)], mesh3)
    assert len(spec) == len(shape)
    used = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh3.shape[a]
            used.append(a)
        assert dim % size == 0, f"{dim} not divisible by {size}"
    assert len(used) == len(set(used)), "mesh axis reused"


def test_fit_spec_drops_nondividing():
    mesh2, mesh3 = MESHES["mesh2"], MESHES["mesh3"]
    assert shd.fit_spec((92553, 6144), ("model", None), mesh2) == (None, None)
    assert shd.fit_spec((152064, 5120), ("model", None), mesh2)[0] == "model"
    assert shd.fit_spec((256, 4096), (shd.DATA, None), mesh3)[0] == \
        ("pod", "data")
    assert shd.fit_spec((1, 4096), (shd.DATA, None), mesh3)[0] is None


def test_reference_names():
    assert shd.reference_name("layers.3.attn.wq") == ("layers/attn/wq", True)
    assert shd.reference_name("embed") == ("embed", False)
    assert shd.reference_name("groups.0.moe.moe.shared.w_up") == \
        ("groups/moe/moe/shared/w_up", True)


def test_opt_state_specs_mirror_params():
    specs = {"embed": ("model", None), "layers.0.ln1": (None,)}
    st = shd.opt_state_specs(None, specs)
    assert st.step == () and st.mu == specs and st.nu == specs


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")

    m = Mesh3()
    assert shd.placements((("pod", "data"), "model"), m) == \
        (Shard(0), Shard(0), Shard(1))
    assert shd.placements((None, "data"), m) == \
        (Replicate(), Shard(1), Replicate())
    assert shd.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shd.placements((("data", "pod"),), m)


def test_constrain_outside_a_policy_is_identity():
    x = torch.ones(2, 3, 4)
    assert shd.constrain_residual(x) is x
    assert shd.constrain(x, (shd.DATA, None, None)) is x
    assert shd.active_mesh() is None
    with shd.activation_policy(MESHES["mesh2"]):
        assert shd.active_mesh() is MESHES["mesh2"]
        assert shd.constrain_residual(x) is x       # not a DTensor
    assert shd.active_mesh() is None


def test_scenario_mesh_on_the_cpu():
    assert scenario_mesh(1, "cpu") == (torch.device("cpu"),)
    assert scenario_mesh(2, "cpu") is None
    assert scenario_mesh(min_devices=2, torch_device="cpu") is None


def test_scenario_mesh_needs_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario_mesh(1)


def test_shard_scenarios_places_on_the_one_device():
    arrays = {"temps": np.linspace(0.1, 1.0, 6).reshape(2, 3),
              "widx": np.array([0, 1], dtype=np.int32),
              "pair": torch.tensor([[True, False]]),
              "strided": np.arange(12.0).reshape(3, 4)[:, ::2]}
    out = shard_scenarios(arrays, (torch.device("cpu"),))
    assert list(out) == list(arrays)
    for k, x in arrays.items():
        t = out[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))
        assert t.numpy().dtype == np.asarray(x).dtype
    assert out["pair"] is arrays["pair"]        # already there: no copy


class RankMesh:
    """Rank ``r`` of an ``n``-rank 1-D mesh on the CPU, without a group."""
    device_type = "cpu"
    mesh_dim_names = ("data",)

    def __init__(self, r, n):
        self.r, self.n = r, n

    def get_local_rank(self):
        return self.r

    def size(self):
        return self.n


def test_shard_scenarios_refuses_several_devices():
    """Several ranks split the cells: each keeps its block of rows when
    the ranks divide the scenario count, and every row when they do
    not. A tuple of several devices (no process group) is refused."""
    x = np.arange(24.0).reshape(8, 3)
    for n in (2, 4, 8):
        blocks = [shard_scenarios({"ci": x}, RankMesh(r, n))["ci"]
                  for r in range(n)]
        assert all(b.shape == (8 // n, 3) for b in blocks)
        np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
        assert [shd.scenario_block(8, RankMesh(r, n)) for r in range(n)] \
            == [(r * 8 // n, (r + 1) * 8 // n) for r in range(n)]
    for r in range(3):
        out = shard_scenarios({"ci": x}, RankMesh(r, 3))["ci"]
        np.testing.assert_array_equal(out.numpy(), x)
    with pytest.raises(ValueError, match="split only over the ranks"):
        shard_scenarios({"ci": x}, (torch.device("cpu"),) * 2)


@pytest.mark.cuda
def test_cuda_mesh_of_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = scenario_mesh(1)
    assert len(mesh) == 1
    out = shard_scenarios({"ci": np.arange(3.0)}, mesh)
    assert out["ci"].device.type == "cuda"
    assert out["ci"].dtype == torch.float64
