"""``repro_torch.analysis`` against the JAX package's ``repro.analysis``.

The reference runs in a subprocess (``test_torch_support.run_reference``)
and reports its own constants, which the tests pass to the port:

- ``gpu_pathfinder.pathfind`` with the reference's figures returns the
  reference's ``tpu_pathfinder.pathfind`` plan and metrics bit for bit,
  for every config of ``ARCH_NAMES``, seeds {0, 1, 7} and carbon weights
  {0, 0.5, 1}; with the H100 record it keeps TP within the NVLink
  domain;
- every ``Roofline`` property, ``format_row`` and ``model_flops_for``
  equal the reference's for every arch x shape (records drawn by numpy);
- ``depth_variants`` equals the reference's field by field
  (``unroll_layers``, which the port's configs do not have, aside);
- the collective counts of one small program: the port's counter over
  ``torch.distributed._functional_collectives`` under a fake process
  group of world size 4, against the reference's ``collective_bytes``
  of the compiled HLO of the same program on 4 forced host devices, for
  each kind XLA keeps as written (it rewrites ``all_to_all`` into a
  tuple of slices, and torch has no collective-permute).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import COLLECTIVE_KINDS, gpu_pathfinder, roofline
from repro_torch.analysis.counting import OpCounter
from repro_torch.analysis.depth import depth_variants
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.core.techdb import DEFAULT_DB
from test_torch_support import run_reference

SEEDS = (0, 1, 7)
WEIGHTS = (0.0, 0.5, 1.0)
BATCH, SEQ = 256, 4096           # the train_4k cell
MESHES = ("single_pod_16x16", "multi_pod_2x16x16")
PROPS = ("t_compute", "t_memory", "t_collective", "step_time_lb",
         "useful_flops_fraction", "mfu_upper_bound", "model_flops")

REF_BODY = """
import dataclasses, json
from repro.analysis import roofline as rl, tpu_pathfinder as tp
from repro.analysis.depth import depth_variants
from repro.configs import ARCH_NAMES, SHAPES, get_config

out["archs"] = np.array(list(ARCH_NAMES))
out["constants"] = np.array([rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_LINK_BW,
                             rl.ICI_LINKS_ACTIVE, tp.CHIP_POWER_W,
                             tp.CHIP_EMBODIED_KG, tp.CHIP_LIFETIME_S,
                             tp.CARBON_INTENSITY, tp.DCN_BW])
plans = []
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    for seed in SEEDS:
        for cw in WEIGHTS:
            p, m = tp.pathfind(cfg, BATCH, SEQ, carbon_weight=cw, seed=seed)
            plans.append([p.chips, p.tp, p.microbatch, p.remat,
                          p.compress_grads, m.step_time_s, m.energy_j,
                          m.emb_cfp_kg, m.ope_cfp_kg, m.hbm_ok])
out["plans"] = np.array(plans, dtype=np.float64)

props, rows, bottlenecks = [], [], []
i = 0
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    for shape in SHAPES:
        rec = {"status": "ok", "arch": arch, "shape": shape.name,
               "mesh": MESHES[i % 2], "flops": float(inp["flops"][i]),
               "bytes_accessed": float(inp["bytes"][i]),
               "collectives": {"total": float(inp["coll"][i])}}
        r = rl.from_record(rec, cfg, shape)
        props.append([getattr(r, k) for k in PROPS])
        rows.append(rl.format_row(r))
        bottlenecks.append(r.bottleneck)
        i += 1
out["props"] = np.array(props, dtype=np.float64)
out["rows"] = np.array(rows)
out["bottlenecks"] = np.array(bottlenecks)
out["header"] = np.array(rl.HEADER)

def fields(c):
    d = dataclasses.asdict(c)
    d.pop("unroll_layers")
    return d

depth = {}
for arch in ARCH_NAMES:
    c1, d1, c2, d2, full = depth_variants(get_config(arch))
    depth[arch] = [fields(c1), d1, fields(c2), d2, full]
out["depth"] = np.array(json.dumps(depth))
"""

COLLECTIVE_BODY = """
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.analysis.hlo import collective_bytes

mesh = Mesh(np.array(jax.devices()), ("x",))

def body(x):
    return (jax.lax.psum(x, "x"),
            jax.lax.all_gather(x, "x", tiled=True),
            jax.lax.psum_scatter(x, "x", scatter_dimension=0, tiled=True),
            jax.lax.all_to_all(x, "x", 0, 0, tiled=True))

f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                      check_vma=False))
assert len(jax.devices()) == 4
x = jnp.ones((4 * ROWS, COLS), jnp.float32)
out["coll"] = np.array(json.dumps(collective_bytes(
    f.lower(x).compile().as_text())))
"""
ROWS, COLS = 8, 16


def _records():
    rng = np.random.default_rng(27)
    n = len(ARCH_NAMES) * len(SHAPES)
    return {"flops": rng.uniform(1e12, 1e18, n),
            "bytes": rng.uniform(1e9, 1e15, n),
            "coll": rng.uniform(0.0, 1e12, n)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    header = (f"SEEDS = {SEEDS!r}\nWEIGHTS = {WEIGHTS!r}\nBATCH = {BATCH}\n"
              f"SEQ = {SEQ}\nMESHES = {MESHES!r}\nPROPS = {PROPS!r}\n")
    return run_reference(header + REF_BODY, _records(),
                         tmp_path_factory.mktemp("analysis"), timeout=600)


@pytest.fixture(scope="module")
def ref_collectives(tmp_path_factory):
    body = (f"import json\nimport jax.numpy as jnp\nROWS = {ROWS}\n"
            f"COLS = {COLS}\n" + COLLECTIVE_BODY)
    out = run_reference(
        body, None, tmp_path_factory.mktemp("collectives"),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    return json.loads(str(out["coll"]))


def _plan_hw(c) -> gpu_pathfinder.PlanHardware:
    """The reference's figures as a PlanHardware (its 16e9 B capacity is
    inline at ``tpu_pathfinder.py:94``, and its TP list ends at 32)."""
    peak, hbm, link, links, power, emb, life, ci, dcn = c
    return gpu_pathfinder.PlanHardware(
        peak_flops=peak, hbm_bytes_per_s=hbm, link_bytes_per_s=link,
        links_active=int(links), chip_power_w=power, chip_embodied_kg=emb,
        chip_lifetime_s=life, carbon_intensity=ci, dcn_bytes_per_s=dcn,
        hbm_bytes=16e9, tp_max=32)


def _roof_hw(c) -> roofline.Hardware:
    peak, hbm, link, links = c[:4]
    return roofline.Hardware("reference constants", bf16_flops=peak,
                             fp32_flops=peak, hbm_bytes_per_s=hbm,
                             hbm_bytes=16e9, link_bytes_per_s=link,
                             links_active=int(links))


def test_same_architectures(ref):
    assert sorted(ref["archs"]) == sorted(ARCH_NAMES)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pathfind_matches_reference_bit_for_bit(ref, arch):
    hw = _plan_hw(ref["constants"])
    cfg = get_config(arch)
    per_arch = len(SEEDS) * len(WEIGHTS)
    at = list(ref["archs"]).index(arch)          # the reference's order
    want = ref["plans"][at * per_arch:][:per_arch]
    got = []
    for seed in SEEDS:
        for cw in WEIGHTS:
            p, m = gpu_pathfinder.pathfind(cfg, BATCH, SEQ, carbon_weight=cw,
                                           seed=seed, hw=hw)
            got.append([p.chips, p.tp, p.microbatch, p.remat,
                        p.compress_grads, m.step_time_s, m.energy_j,
                        m.emb_cfp_kg, m.ope_cfp_kg, m.hbm_ok])
    np.testing.assert_array_equal(np.array(got, dtype=np.float64), want)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_h100_plan_keeps_tp_in_the_nvlink_domain(arch):
    cfg = get_config(arch)
    for cw in WEIGHTS:
        plan, m = gpu_pathfinder.pathfind(cfg, BATCH, SEQ, carbon_weight=cw,
                                          iters=1000)
        assert plan.tp <= gpu_pathfinder.H100_PLAN.tp_max == 8
        assert m.hbm_ok and m.step_time_s > 0 and m.total_cfp > 0


def test_h100_embodied_is_the_eco_chip_die_estimate():
    """814 mm^2 at 7 nm through the port's ECO-CHIP model: area x carbon
    per area over die yield, plus the design carbon's per-unit share
    (the default TechDB's recycling and wasted-die knobs are neutral)."""
    db = DEFAULT_DB
    area = 814.0
    assert db.wasted_die_scale == 0.0 and db.rcy_mat_frac == 0.0
    want = (area * db.node_cpa[7] / db.die_yield(area, 7)
            + db.node_design_cfp[7] / db.production_volume)
    got = gpu_pathfinder.h100_embodied_kg()
    assert got == pytest.approx(want, rel=1e-15)
    assert gpu_pathfinder.H100_PLAN.chip_embodied_kg == got
    doc = gpu_pathfinder.__doc__
    assert "814" in doc and "ECO-CHIP" in doc and f"{got:.2f} kg" in doc


def test_roofline_matches_reference(ref):
    hw = _roof_hw(ref["constants"])
    recs = _records()
    i = 0
    for arch in map(str, ref["archs"]):          # the reference's order
        cfg = get_config(arch)
        for shape in SHAPES:
            mesh = MESHES[i % 2]
            rec = {"status": "ok", "arch": arch, "shape": shape.name,
                   "mesh": mesh, "chips": 512 if "multi" in mesh else 256,
                   "flops": float(recs["flops"][i]),
                   "bytes_accessed": float(recs["bytes"][i]),
                   "collectives": {"total": float(recs["coll"][i])}}
            r = roofline.from_record(rec, cfg, shape, hw, hw.bf16_flops)
            got = [getattr(r, k) for k in PROPS]
            np.testing.assert_array_equal(np.array(got, dtype=np.float64),
                                          ref["props"][i],
                                          err_msg=f"{arch} x {shape.name}")
            assert r.bottleneck == ref["bottlenecks"][i]
            assert roofline.format_row(r) == ref["rows"][i]
            assert r.model_flops == roofline.model_flops_for(cfg, shape)
            i += 1
    assert roofline.HEADER == str(ref["header"])
    assert roofline.from_record({"status": "error"}, cfg, shape, hw,
                                hw.bf16_flops) is None


def test_h100_constants_come_from_the_data_sheet():
    h = roofline.H100
    assert (h.bf16_flops, h.fp32_flops, h.hbm_bytes_per_s, h.hbm_bytes) == \
        (989e12, 67e12, 3.35e12, 80e9)
    assert h.link_bytes_per_s * h.links_active == 450e9   # NVLink, one way
    assert h.peak_flops(torch.bfloat16) == 989e12
    assert h.peak_flops(torch.float32) == 67e12
    r = roofline.Roofline("a", "s", "one", 1, 67e12, 0.0, 0.0, 67e12, h,
                          h.peak_flops(torch.float32))
    assert r.step_time_lb == 1.0 and r.mfu_upper_bound == 1.0
    assert r.bottleneck == "compute"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_depth_variants_match_reference(ref, arch):
    want = json.loads(str(ref["depth"]))[arch]
    c1, d1, c2, d2, full = depth_variants(get_config(arch))
    got = json.loads(json.dumps([dataclasses.asdict(c1), d1,
                                 dataclasses.asdict(c2), d2, full]))
    assert got == want


def test_collectives_match_reference_hlo(ref_collectives):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore

    gather = getattr(fc, "all_gather_single", fc.all_gather_tensor)
    scatter = getattr(fc, "reduce_scatter_single", fc.reduce_scatter_tensor)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        group = dist.group.WORLD
        x = torch.ones(ROWS, COLS)
        with OpCounter("cpu") as c:
            outs = [fc.all_reduce(x, "sum", group), gather(x, 0, group),
                    scatter(x, "sum", 0, group),
                    fc.all_to_all_single(x, None, None, group)]
            for y in outs:               # a use waits for each result
                (y + 0).sum()
    finally:
        dist.destroy_process_group()
    got = c.collectives
    # kinds XLA keeps as written: each of the program's ops once, in its
    # array form (all_to_all comes back as a tuple of four slices)
    kept = ("all-reduce", "all-gather", "reduce-scatter")
    for kind in kept:
        assert ref_collectives[kind + "_count"] == 1
        assert got[kind] == ref_collectives[kind], kind
        assert got[kind + "_count"] == ref_collectives[kind + "_count"]
    assert got["all-to-all"] == ROWS * COLS * 4
    assert got["all-to-all_count"] == 1
    assert set(got) <= set(COLLECTIVE_KINDS) | {
        k + "_count" for k in COLLECTIVE_KINDS} | {"total"}
    assert got["total"] == sum(got[k] for k in COLLECTIVE_KINDS if k in got)
