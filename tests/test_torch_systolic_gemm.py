"""The systolic GEMM: the port's ``systolic_gemm`` (its wrapper, on the
CPU through the plain versions) against the reference's
``systolic_gemm`` in interpret mode, over the shapes, dataflows, split-K
values, dtypes and tiles of ``tests/test_kernels.py`` and the Table IV
workloads WL1, WL3, WL4, WL5 and WL6 at the default 128^3 tile under OS,
OS split-K 2 and 4, WS and IS (WL2 runs on the card, in
``chip_smoke.py``); each kernel-level plain function and wrapper against
the reference's kernel-level function (``kernel.os_gemm`` and the
others, in interpret mode); ``gemm_plain`` against the reference; the
wrapper's refusals; and each CUDA kernel against its plain version on
the card.

Inputs are standard normal from numpy with a seed, rounded to the
operand dtype.

Tolerance: max |error| <= tol x Mag, with Mag = max over (m, n) of
sum_k |a_mk| |b_kn| in float64 (for a slab, over the slab's own
k-range); tol = 1e-5 for float32 outputs and slabs, 2^-7 for bfloat16 and
float16 outputs. Two float32 evaluations differ by summation order, an
error that scales with Mag and not with the output, which can cancel;
a bfloat16 (float16) output is rounded once on each side, up to 2^-8
(2^-11) of |out| <= Mag each.
"""
import numpy as np
import pytest
import torch

from test_torch_support import run_reference

from repro_torch.kernels.systolic_gemm import (
    gemm_plain,
    is_gemm_partials,
    is_gemm_partials_plain,
    launch_count,
    os_gemm,
    os_gemm_plain,
    os_gemm_splitk,
    os_gemm_splitk_plain,
    systolic_gemm,
    ws_gemm_partials,
    ws_gemm_partials_plain,
)
from repro_torch.kernels.systolic_gemm.ops import (
    check_tile,
    kernel_path,
    smem_bytes,
    spill_path,
)

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -7}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
TABLE_IV = {1: (512, 768, 3072), 3: (197, 768, 3072), 4: (128, 2048, 1000),
            5: (64, 4096, 4096), 6: (1316, 24, 144)}     # (M, K, N)
SETTINGS = [("OS", 1), ("OS", 2), ("OS", 4), ("WS", 1), ("IS", 1)]
TILES = [(64, 64, 64), (32, 64, 32), (32, 32, 32), (64, 128, 32),
         (128, 64, 96)]


def _cases():
    """(id, (M, K, N), dtype, tile, dataflow, split_k, out_dtype)."""
    cases = []
    for shape in [(128, 128, 128), (200, 300, 450), (64, 512, 64),
                  (1, 256, 257)]:
        for df in ("OS", "WS", "IS"):
            cases.append((shape, "float32", (64, 64, 64), df, 1, None))
    for sk in (2, 4):
        cases.append(((96, 512, 160), "float32", (32, 64, 32), "OS", sk,
                      None))
    for dt in ("float32", "bfloat16", "float16"):
        cases.append(((128, 128, 128), dt, (64, 64, 64), "OS", 1, None,
                      "dtype"))
    for df in ("OS", "WS"):
        cases.append(((128, 128, 128), "bfloat16", (64, 64, 64), df, 1,
                      "float32", "dtype"))
    for tile in TILES:
        for df, sk in [("OS", 1), ("OS", 2), ("WS", 1), ("IS", 1)]:
            cases.append(((160, 224, 96), "float32", tile, df, sk, None))
    for wl, shape in TABLE_IV.items():
        for df, sk in SETTINGS:
            cases.append((shape, "float32", (128, 128, 128), df, sk, None,
                          f"wl{wl}"))
    out = []
    for c in cases:
        shape, dt, tile, df, sk, od = c[:6]
        tag = c[6] if len(c) > 6 else "x".join(map(str, shape))
        cid = (f"{tag}-{dt}-{'x'.join(map(str, tile))}-{df}{sk}"
               f"{'-to-' + od if od else ''}")
        out.append((cid, shape, dt, tile, df, sk, od))
    return out


CASES = _cases()

# kernel-level calls on tile multiples: (id, (M, K, N), dtype, tile, site,
# splits)
SITES = []
for _shape, _dt, _tile, _sk in [
        ((256, 512, 384), "float32", (128, 128, 128), 2),
        ((96, 192, 160), "float32", (32, 64, 32), 3),
        ((128, 256, 128), "bfloat16", (64, 64, 64), 2)]:
    for _site, _splits in [("os_gemm", 1), ("os_gemm_splitk", _sk),
                           ("ws_gemm_partials", 1), ("is_gemm_partials", 1)]:
        SITES.append((f"{_site}-{'x'.join(map(str, _shape))}-{_dt}", _shape,
                      _dt, _tile, _site, _splits))
KERNELS = {"os_gemm": (os_gemm, os_gemm_plain),
           "os_gemm_splitk": (os_gemm_splitk, os_gemm_splitk_plain),
           "ws_gemm_partials": (ws_gemm_partials, ws_gemm_partials_plain),
           "is_gemm_partials": (is_gemm_partials, is_gemm_partials_plain)}


def _key(shape, dt):
    return f"{'x'.join(map(str, shape))}_{dt}"


def _operands(shape, dt):
    """float32 numpy operands holding values exact in ``dt``."""
    m, k, n = shape
    seed = (m * 7919 + k * 104729 + n) * 3 + list(DTYPES).index(dt)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    return tuple(torch.from_numpy(x).to(DTYPES[dt]).float().numpy()
                 for x in (a, b))


def _tensors(shape, dt):
    return tuple(torch.from_numpy(x).to(DTYPES[dt])
                 for x in _operands(shape, dt))


_MAG = {}


def magnitude(shape, dt, n_slabs=1):
    """Mag per slab (module docstring), float64; one value for the whole
    product when ``n_slabs`` is 1."""
    key = (shape, dt, n_slabs)
    if key not in _MAG:
        a, b = (np.abs(x.astype(np.float64)) for x in _operands(shape, dt))
        kq = a.shape[1] // n_slabs
        _MAG[key] = np.array([
            (a[:, s * kq:(s + 1) * kq] @ b[s * kq:(s + 1) * kq]).max()
            for s in range(n_slabs)])
    return _MAG[key]


REF = """
import jax.numpy as jnp
from repro.kernels.systolic_gemm import systolic_gemm
from repro.kernels.systolic_gemm import kernel as K
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}


def operands(shape, dt):
    key = "x".join(map(str, shape)) + "_" + dt
    return (jnp.asarray(inp[key + "_a"]).astype(DT[dt]),
            jnp.asarray(inp[key + "_b"]).astype(DT[dt]))


for cid, shape, dt, (bm, bk, bn), df, sk, od in CASES:
    a, b = operands(shape, dt)
    res = systolic_gemm(a, b, bm=bm, bk=bk, bn=bn, dataflow=df, split_k=sk,
                        out_dtype=DT[od] if od else None, interpret=True)
    out[cid] = res.astype(jnp.float32)
    out[cid + "_dtype"] = np.array(str(res.dtype))
for cid, shape, dt, (bm, bk, bn), site, splits in SITES:
    a, b = operands(shape, dt)
    kw = dict(bm=bm, bk=bk, bn=bn, interpret=True)
    if site == "os_gemm":
        res = K.os_gemm(a, b, out_dtype=DT[dt], **kw)
    elif site == "os_gemm_splitk":
        res = K.os_gemm_splitk(a, b, splits=splits, out_dtype=jnp.float32,
                               **kw)
    else:
        res = getattr(K, site)(a, b, **kw)
    out[cid] = res.astype(jnp.float32)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {}
    for c in CASES + SITES:
        shape, dt = c[1], c[2]
        a, b = _operands(shape, dt)
        inputs[_key(shape, dt) + "_a"] = a
        inputs[_key(shape, dt) + "_b"] = b
    body = f"CASES = {CASES!r}\nSITES = {SITES!r}\n" + REF
    return run_reference(body, inputs, tmp_path_factory.mktemp("ref_gemm"),
                         timeout=900)


def slab_magnitudes(a, b, n_slabs):
    """Mag per slab of tensors on any device, in float64."""
    a, b = a.double().abs(), b.double().abs()
    kq = a.shape[1] // n_slabs
    return np.array([float((a[:, s * kq:(s + 1) * kq]
                            @ b[s * kq:(s + 1) * kq]).max())
                     for s in range(n_slabs)])


def _close(got, want, mags, tol, what):
    """Each slab (leading axis when ``mags`` has several) within tol x its
    Mag."""
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).reshape(len(mags), -1)
    worst = err.max(axis=1)
    assert np.all(worst <= tol * mags), (
        f"{what}: max abs err {worst.max()} > {tol} x Mag {mags.tolist()}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_systolic_gemm_matches_reference(ref, case):
    cid, shape, dt, (bm, bk, bn), df, sk, od = case
    a, b = _tensors(shape, dt)
    before = launch_count()
    got = systolic_gemm(a, b, bm=bm, bk=bk, bn=bn, dataflow=df, split_k=sk,
                        out_dtype=DTYPES[od] if od else None)
    assert launch_count() == before            # the CPU never launches
    out_dt = od or dt
    assert got.dtype == DTYPES[out_dt]
    assert str(ref[cid + "_dtype"]) == out_dt
    _close(got, ref[cid], magnitude(shape, dt), TOL[out_dt], cid)


_PLAIN = sorted({(c[1], c[2]) for c in CASES if c[4] == "OS" and c[5] == 1
                 and c[6] is None and c[3] in ((64, 64, 64),
                                               (128, 128, 128))})


@pytest.mark.parametrize("shape,dt", _PLAIN,
                         ids=[_key(s, d) for s, d in _PLAIN])
def test_gemm_plain_matches_reference(ref, shape, dt):
    """``gemm_plain`` (the oracle the card holds the kernels to) against
    the reference's OS output of the same operands."""
    cid = next(c[0] for c in CASES if (c[1], c[2]) == (shape, dt)
               and c[4] == "OS" and c[5] == 1 and c[6] is None)
    got = gemm_plain(*_tensors(shape, dt))
    assert got.dtype == DTYPES[dt]
    _close(got, ref[cid], magnitude(shape, dt), TOL[dt], cid)


@pytest.mark.parametrize("impl", ["plain", "wrapper"])
@pytest.mark.parametrize("case", SITES, ids=[c[0] for c in SITES])
def test_kernel_level_matches_reference(ref, case, impl):
    cid, shape, dt, (bm, bk, bn), site, splits = case
    fn = KERNELS[site][impl == "plain"]
    a, b = _tensors(shape, dt)
    kw = dict(bm=bm, bk=bk, bn=bn)
    if site == "os_gemm":
        got = fn(a, b, out_dtype=DTYPES[dt], **kw)
        assert got.dtype == DTYPES[dt]
        _close(got, ref[cid], magnitude(shape, dt), TOL[dt], cid)
        return
    if site == "os_gemm_splitk":
        got, n_slabs = fn(a, b, splits=splits, **kw), splits
    else:
        got, n_slabs = fn(a, b, **kw), shape[1] // bk
    assert got.dtype == torch.float32 and got.shape[0] == n_slabs
    _close(got, ref[cid], magnitude(shape, dt, n_slabs), TOL["float32"], cid)


def _bad(kind):
    a, b = _tensors((64, 96, 80), "float32")
    kw = {}
    if kind == "dataflow":
        kw["dataflow"] = "RS"
    elif kind == "rank":
        a = a[None]
    elif kind == "inner_dim":
        b = b[:-1]
    elif kind == "empty":
        a, b = a[:0], b
    elif kind == "devices":
        b = b.to("meta")
    elif kind == "float64":
        a, b = a.double(), b.double()
    elif kind == "mixed_dtypes":
        b = b.bfloat16()
    elif kind == "out_dtype":
        kw["out_dtype"] = torch.int32
    elif kind == "tile_too_wide":
        kw.update(bm=256)
    elif kind == "tile_not_multiple_of_16":
        kw.update(bn=24)
    elif kind == "tile_over_shared_memory":
        kw.update(bk=512, dataflow="IS")
    return (a, b), kw


@pytest.mark.parametrize("kind,exc", [
    ("dataflow", ValueError), ("rank", ValueError), ("inner_dim", ValueError),
    ("empty", ValueError), ("devices", ValueError), ("float64", TypeError),
    ("mixed_dtypes", TypeError), ("out_dtype", TypeError),
    ("tile_too_wide", ValueError), ("tile_not_multiple_of_16", ValueError),
    ("tile_over_shared_memory", ValueError)])
def test_wrapper_rejects_bad_input(kind, exc):
    args, kw = _bad(kind)
    with pytest.raises(exc):
        systolic_gemm(*args, **kw)


def test_refused_tile_names_the_tile():
    a, b = _tensors((64, 96, 80), "float32")
    with pytest.raises(ValueError, match=r"bm=128, bk=512, bn=128.*IS"):
        systolic_gemm(a, b, bk=512, dataflow="IS")


@pytest.mark.parametrize("site", sorted(KERNELS))
def test_kernel_level_rejects_ragged_operands(site):
    """The kernel-level functions take tile multiples only (the wrapper
    pads)."""
    a, b = _tensors((96, 128, 128), "float32")
    kw = dict(bm=64, bk=64, bn=64)
    if site == "os_gemm":
        kw["out_dtype"] = torch.float32
    elif site == "os_gemm_splitk":
        kw["splits"] = 2
    with pytest.raises(ValueError, match="multiples"):
        KERNELS[site][0](a, b, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tile", [
    ((512, 768, 3072), (128, 128, 128)), ((160, 224, 96), (32, 64, 32)),
    ((1316, 24, 144), (128, 64, 96))])
def test_cuda_kernels_match_plain_on_card(shape, tile, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    bm, bk, bn = tile
    a, b = (x.cuda() for x in _tensors(shape, dt))
    for df, sk in SETTINGS:
        got = systolic_gemm(a, b, bm=bm, bk=bk, bn=bn, dataflow=df,
                            split_k=sk)
        want = gemm_plain(a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[dt] * magnitude(shape, dt)[0], (df, sk, err)
    m, k, n = shape
    mp, kp, np_ = (-(-m // bm) * bm, -(-k // (2 * bk)) * 2 * bk,
                   -(-n // bn) * bn)
    ap = torch.zeros((mp, kp), dtype=a.dtype, device="cuda")
    bp = torch.zeros((kp, np_), dtype=a.dtype, device="cuda")
    ap[:m, :k], bp[:k, :n] = a, b
    for site, (fn, plain) in KERNELS.items():
        kw = dict(bm=bm, bk=bk, bn=bn)
        if site == "os_gemm":
            kw["out_dtype"] = a.dtype
        elif site == "os_gemm_splitk":
            kw["splits"] = 2
        before = fn.launches
        got = fn(ap, bp, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(ap, bp, **kw)
        if site == "os_gemm":
            tol, mags = TOL[dt], slab_magnitudes(ap, bp, 1)
        else:
            tol, mags = TOL["float32"], slab_magnitudes(ap, bp, len(got))
        _close(got.cpu(), want.cpu().double().numpy(), mags, tol, site)


@pytest.mark.parametrize("dt,tile,want", [
    ("bfloat16", (128, 128, 128), "wgmma"), ("float16", (128, 128, 128),
                                             "wgmma"),
    ("bfloat16", (64, 64, 64), "wgmma"), ("float16", (128, 64, 64), "wgmma"),
    ("bfloat16", (64, 48, 128), "wgmma"), ("bfloat16", (128, 16, 64),
                                           "wgmma"),
    ("float32", (128, 128, 128), "simt"), ("float32", (64, 64, 64), "simt"),
    ("bfloat16", (128, 64, 96), "simt"), ("float16", (32, 32, 32), "simt"),
    ("bfloat16", (96, 128, 128), "simt"), ("bfloat16", (128, 40, 128),
                                           "simt"),
    ("float16", (64, 7, 64), "simt")])
def test_spill_path(dt, tile, want):
    """WS/IS run on wgmma for 16-bit operands at bm, bn in {64, 128} and
    bk % 16 == 0, and on the float32 FFMA kernel otherwise."""
    assert spill_path(DTYPES[dt], *tile) == want


# every tile of these tests, of chip_smoke.py and of tests/test_kernels.py
_USED_TILES = sorted(set(TILES) | {(128, 128, 128), (64, 64, 64)})


@pytest.mark.parametrize("df", ["OS", "WS", "IS"])
@pytest.mark.parametrize("tile", _USED_TILES,
                         ids=["x".join(map(str, t)) for t in _USED_TILES])
def test_used_tiles_are_accepted(df, tile):
    check_tile(df, *tile)
    assert smem_bytes(df, *tile) <= 232448


@pytest.mark.parametrize("df,bk_max,want_128", [("WS", 388, 99328),
                                                ("IS", 378, 100352)])
def test_spill_bk_limit_at_128(df, bk_max, want_128):
    """The simt footprint, which decides the accepted set on both paths:
    at bm = bn = 128, WS takes bk up to 388 and IS up to 378."""
    assert smem_bytes(df, 128, 128, 128) == want_128
    check_tile(df, 128, bk_max, 128)
    with pytest.raises(ValueError, match=f"bk={bk_max + 1}.*{df}"):
        check_tile(df, 128, bk_max + 1, 128)


# (site, (M, K, N), tile): sweeps of 7 steps, so the wgmma ring (2-4
# stages, 1-6 chunks a step) wraps several times; K/bk of 2 or 3; every
# compiled N (64, 128) at bm = 64 and 128; k-chunks of 64 and 16; a
# 16-bit tile that takes the simt path; a bk that is not a multiple of 4.
_SPILL_CASES = [
    ("ws", (7 * 128, 256, 256), (128, 128, 128)),
    ("is", (256, 256, 7 * 128), (128, 128, 128)),
    ("ws", (7 * 64, 192, 128), (64, 64, 64)),
    ("is", (128, 192, 7 * 64), (64, 64, 64)),
    ("ws", (7 * 64, 128, 256), (64, 64, 128)),
    ("is", (256, 128, 7 * 128), (128, 64, 128)),
    ("ws", (7 * 128, 96, 128), (128, 48, 64)),
    ("is", (128, 96, 7 * 64), (64, 48, 64)),
    ("ws", (256, 128, 192), (128, 64, 96)),
    ("is", (96, 14, 64), (32, 7, 32)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("site,shape,tile", _SPILL_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}"
                              for c in _SPILL_CASES])
def test_cuda_spill_paths_match_plain_on_card(site, shape, tile, dt):
    """WS/IS on the card, on the path ``spill_path`` names, slab by slab
    within 1e-5 x each slab's Mag of the plain ``bmm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, plain = KERNELS[f"{site}_gemm_partials"]
    bm, bk, bn = tile
    a, b = (x.cuda() for x in _tensors(shape, dt))
    path = spill_path(a.dtype, bm, bk, bn)
    before = dict(fn.path_launches)
    got = fn(a, b, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert fn.path_launches[path] == before[path] + 1
    want = plain(a, b, bm=bm, bk=bk, bn=bn)
    assert got.shape == (shape[1] // bk, shape[0], shape[2])
    _close(got.cpu(), want.cpu().double().numpy(),
           slab_magnitudes(a, b, len(got)), TOL["float32"],
           f"{site} {path}")


_PATH_CASES = [
    ("bfloat16", (128, 128, 128), "wgmma"), ("float16", (128, 128, 128),
                                             "wgmma"),
    ("bfloat16", (64, 64, 64), "wgmma"), ("float16", (128, 64, 64), "wgmma"),
    ("bfloat16", (64, 48, 128), "wgmma"), ("bfloat16", (128, 16, 64),
                                           "wgmma"),
    ("float16", (64, 4096, 128), "wgmma"),
    ("float32", (128, 128, 128), "simt"), ("float32", (64, 64, 64), "simt"),
    ("bfloat16", (128, 64, 96), "simt"), ("float16", (32, 32, 32), "simt"),
    ("bfloat16", (96, 128, 128), "simt"), ("bfloat16", (128, 40, 128),
                                           "simt"),
    ("float16", (64, 7, 64), "simt"), ("bfloat16", (16, 16, 16), "simt")]


@pytest.mark.parametrize("dt,tile,want", _PATH_CASES)
def test_os_path(dt, tile, want):
    """OS and split-K follow the WS/IS rule: wgmma for 16-bit operands at
    bm, bn in {64, 128} and bk % 16 == 0 (at any bk, as OS accepts every
    bk), the float32 FFMA kernel otherwise. One rule for the four sites."""
    assert kernel_path(DTYPES[dt], *tile) == want
    assert spill_path(DTYPES[dt], *tile) == want


_SIDES = list(range(16, 129, 16))


@pytest.mark.parametrize("bm", _SIDES)
def test_os_accepts_every_tile_at_any_bk(bm):
    """OS and split-K take every bm, bn (multiples of 16 up to 128) at any
    bk: the footprint has no bk term."""
    for bn in _SIDES:
        for bk in (1, 7, 16, 48, 128, 1000, 4096, 100000):
            check_tile("OS", bm, bk, bn)
            assert smem_bytes("OS", bm, bk, bn) == smem_bytes("OS", bm, 1, bn)
    for bn in (8, 24, 144, 256):
        with pytest.raises(ValueError, match="multiples of 16"):
            check_tile("OS", bm, 128, bn)


def test_os_smem_is_the_c_formula():
    """``smem_bytes("OS", ...)`` mirrors ``os_smem`` in the source: two
    32-deep float32 buffers of sA (pitch bm + 4) and sB (pitch bn)."""
    assert smem_bytes("OS", 128, 128, 128) == 4 * 2 * 32 * (128 + 4 + 128)
    assert smem_bytes("OS", 128, 128, 128) == 66560
    assert smem_bytes("OS", 16, 16, 16) == 9216
    check_tile("OS", 128, 4096, 128)


# (M, N, tile) of the OS kernels on the card, each run over K = 7 bk per
# shard, so the wgmma ring (3-8 stages) wraps several times: every
# compiled N (64, 128) at bm = 64 and 128, k-chunks of 64 and of 16 (bk
# 48); then tiles that take the simt path: 32^3, 16^3 (4 x 4 register
# blocks), (128, 64, 96) (8 x 8 at a runtime tile), 128^3 and a bk that is
# not a multiple of 4.
_OS_CASES = [
    (256, 256, (128, 128, 128)), (128, 128, (64, 64, 64)),
    (256, 128, (128, 64, 64)), (128, 256, (64, 64, 128)),
    (256, 256, (128, 48, 128)), (128, 128, (64, 48, 64)),
    (96, 96, (32, 32, 32)), (48, 48, (16, 16, 16)),
    (256, 192, (128, 64, 96)), (64, 64, (32, 7, 32))]
_OS_IDS = ["x".join(map(str, c[2])) for c in _OS_CASES]


def _os_on_card(m, n, tile, dt, splits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    bm, bk, bn = tile
    shape = (m, 7 * splits * bk, n)
    a, b = (x.cuda() for x in _tensors(shape, dt))
    return a, b, kernel_path(a.dtype, bm, bk, bn)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dt", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("m,n,tile", _OS_CASES, ids=_OS_IDS)
def test_cuda_os_gemm_paths_match_plain_on_card(m, n, tile, dt, out):
    """``os_gemm`` on the path ``kernel_path`` names, within 1e-5 x Mag
    (float32 output) or 2^-7 x Mag (16-bit output) of the plain version."""
    a, b, path = _os_on_card(m, n, tile, dt, 1)
    bm, bk, bn = tile
    before = dict(os_gemm.path_launches)
    got = os_gemm(a, b, bm=bm, bk=bk, bn=bn, out_dtype=DTYPES[out])
    torch.cuda.synchronize()
    assert os_gemm.path_launches[path] == before[path] + 1
    assert got.dtype == DTYPES[out] and got.shape == (m, n)
    want = os_gemm_plain(a, b, bm=bm, bk=bk, bn=bn, out_dtype=torch.float32)
    _close(got.cpu(), want.cpu().double().numpy(), slab_magnitudes(a, b, 1),
           TOL[out], f"os_gemm {path}")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("dt", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("m,n,tile", _OS_CASES, ids=_OS_IDS)
def test_cuda_os_splitk_paths_match_plain_on_card(m, n, tile, dt, splits):
    """``os_gemm_splitk`` on the path ``kernel_path`` names, slab by slab
    within 1e-5 x each slab's Mag of the plain ``bmm``."""
    a, b, path = _os_on_card(m, n, tile, dt, splits)
    bm, bk, bn = tile
    before = dict(os_gemm_splitk.path_launches)
    got = os_gemm_splitk(a, b, splits=splits, bm=bm, bk=bk, bn=bn)
    torch.cuda.synchronize()
    assert os_gemm_splitk.path_launches[path] == before[path] + 1
    assert got.shape == (splits, m, n) and got.dtype == torch.float32
    want = os_gemm_splitk_plain(a, b, splits=splits, bm=bm, bk=bk, bn=bn)
    _close(got.cpu(), want.cpu().double().numpy(),
           slab_magnitudes(a, b, splits), TOL["float32"],
           f"os_gemm_splitk {path}")
