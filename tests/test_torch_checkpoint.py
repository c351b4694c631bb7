"""The port's checkpoint module (``repro_torch.checkpoint``): every case
of the reference's ``tests/test_checkpoint.py`` on the port (mixed-dtype
trees, 0-d leaves, elastic restores, trees of ParetoArchives, the
corrupt-checkpoint prune-and-fall-back of ``CheckpointManager.restore``),
and the on-disk format against a live run of the reference: a tree with
archives, 0-d and ``ELASTIC`` leaves written by either package loads in
the other, and the two manifests name the same leaves in the same order
with the same dtypes, shapes and checksum. Exact throughout."""
import json
import os
import tempfile

import numpy as np
import pytest

from test_torch_support import run_reference

from repro_torch.checkpoint import (
    ELASTIC,
    CheckpointManager,
    CorruptCheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpoint import MANIFEST, _leaf_paths
from repro_torch.pathfinding import ParetoArchive


def _mixed_tree():
    return {
        "ints": np.arange(12, dtype=np.int32).reshape(3, 4),
        "floats": np.linspace(0.0, 1.0, 7),          # float64
        "scalar_f": np.float64(3.25),                # 0-d float64
        "scalar_i": np.int64(11),                    # 0-d int64
        "nested": {"u32": np.asarray([1, 2], dtype=np.uint32),
                   "bools": np.asarray([True, False, True])},
        "listy": [np.zeros(3, dtype=np.int32), np.ones((2, 2))],
    }


def _assert_tree_equal(a, b):
    la = [leaf for _, leaf in _leaf_paths(a)]
    lb = [leaf for _, leaf in _leaf_paths(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def test_roundtrip_mixed_dtypes_and_0d_leaves():
    with tempfile.TemporaryDirectory() as d:
        t = _mixed_tree()
        p = save_checkpoint(d, 3, t, n_shards=2)
        step, r = load_checkpoint(p, t)
        assert step == 3
        _assert_tree_equal(t, r)
        assert isinstance(r["listy"], list)


@pytest.mark.parametrize("save_shards,load_mgr_shards", [(1, 8), (5, 2)])
def test_elastic_restore_across_n_shards(save_shards, load_mgr_shards):
    """n_shards only shapes the on-disk layout: restore reassembles the
    logical arrays regardless of the manager's own shard setting."""
    with tempfile.TemporaryDirectory() as d:
        t = _mixed_tree()
        save_checkpoint(d, 1, t, n_shards=save_shards)
        mgr = CheckpointManager(d, keep=3, n_shards=load_mgr_shards)
        step, r = mgr.restore(t)
        assert step == 1
        _assert_tree_equal(t, r)


def test_elastic_template_leaf_takes_manifest_shape():
    """An ELASTIC template leaf restores with the saved shape — the
    grow-only history vector of a resumed search."""
    with tempfile.TemporaryDirectory() as d:
        t = {"hist": np.arange(9.0), "step": np.int64(4)}
        p = save_checkpoint(d, 4, t)
        _, r = load_checkpoint(p, {"hist": ELASTIC,
                                   "step": np.zeros((), np.int64)})
        np.testing.assert_array_equal(np.asarray(r["hist"]), t["hist"])
        # a non-elastic mismatch still fails loudly
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(p, {"hist": np.zeros(2),
                                "step": np.zeros((), np.int64)})


def _archive(rows):
    a = ParetoArchive(max_size=64)
    enc = np.arange(rows * 5, dtype=np.int32).reshape(rows, 5)
    vec = np.stack([np.arange(rows, dtype=np.float64),
                    -np.arange(rows, dtype=np.float64),
                    np.ones(rows)], axis=1)
    a.insert(enc, vec)
    return a


def test_pytree_of_archives_roundtrip():
    """ParetoArchive objects ride inside checkpoint trees: expanded to
    array dicts on save, rebuilt (with elastic row counts) on load."""
    with tempfile.TemporaryDirectory() as d:
        archives = [_archive(3), _archive(7), ParetoArchive(max_size=8)]
        tree = {"archives": archives, "counter": np.int64(2)}
        p = save_checkpoint(d, 2, tree)
        # templates are EMPTY archives: row counts come from the manifest
        like = {"archives": [ParetoArchive(max_size=64) for _ in range(3)],
                "counter": np.zeros((), np.int64)}
        _, r = load_checkpoint(p, like)
        for orig, got in zip(archives, r["archives"]):
            assert isinstance(got, ParetoArchive)
            assert got.max_size == 64
            np.testing.assert_array_equal(got.encoded, orig.encoded)
            np.testing.assert_array_equal(got.vectors, orig.vectors)


def test_subset_template_restore_is_not_misread_as_corruption():
    """The checksum covers the whole payload; a template asking for a
    subset of the saved leaves must verify against it (a false
    corruption verdict would PRUNE valid snapshots) and restore the
    subset."""
    with tempfile.TemporaryDirectory() as d:
        full = {"a": np.arange(4.0), "b": np.arange(6, dtype=np.int32),
                "arch": _archive(3)}
        mgr = CheckpointManager(d, keep=3)
        mgr.save(7, full)
        step, r = mgr.restore({"a": np.zeros(4)})
        assert step == 7
        np.testing.assert_array_equal(np.asarray(r["a"]), full["a"])
        # nothing was pruned: the snapshot is intact and fully loadable
        assert mgr.all_steps() == [7]
        _, r2 = mgr.restore({"a": np.zeros(4),
                             "b": np.zeros(6, np.int32),
                             "arch": ParetoArchive(max_size=64)})
        np.testing.assert_array_equal(r2["arch"].encoded,
                                      full["arch"].encoded)


def test_restore_prunes_corrupt_and_falls_back():
    """A torn copy of the newest checkpoint must not poison restart:
    restore skips + prunes it and lands on the next-newest valid step."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=5)
        t5 = {"x": np.full(4, 5.0)}
        t9 = {"x": np.full(4, 9.0)}
        mgr.save(5, t5)
        p9 = mgr.save(9, t9)
        # corrupt step 9's payload (bit-flip a shard, keep the manifest)
        shard = [f for f in os.listdir(p9) if f.endswith(".npy")][0]
        arr = np.load(os.path.join(p9, shard))
        np.save(os.path.join(p9, shard), arr + 1.0)
        step, r = mgr.restore({"x": np.zeros(4)})
        assert step == 5
        np.testing.assert_array_equal(np.asarray(r["x"]), t5["x"])
        # the poisoned directory is gone, not retried forever
        assert mgr.all_steps() == [5]


def test_restore_prunes_truncated_shard_and_unreadable_manifest():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=5)
        t = {"x": np.arange(6.0)}
        mgr.save(1, t)
        p2 = mgr.save(2, t)
        p3 = mgr.save(3, t)
        # step 3: unreadable manifest; step 2: truncated shard file
        with open(os.path.join(p3, MANIFEST), "w") as f:
            f.write("{not json")
        shard = [f for f in os.listdir(p2) if f.endswith(".npy")][0]
        with open(os.path.join(p2, shard), "wb") as f:
            f.write(b"\x93NUMPY")  # magic only, no header/payload
        step, _ = mgr.restore({"x": np.zeros(6)})
        assert step == 1
        assert mgr.all_steps() == [1]


def test_restore_all_corrupt_raises_filenotfound():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        p = mgr.save(1, {"x": np.zeros(3)})
        with open(os.path.join(p, MANIFEST), "w") as f:
            f.write("")
        with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
            mgr.restore({"x": np.zeros(3)})


def test_structural_mismatch_is_not_pruned():
    """A *valid* checkpoint that does not fit the template is a caller
    bug: restore raises and leaves the directory alone."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        mgr.save(1, {"x": np.zeros(3)})
        with pytest.raises(KeyError, match="missing leaf"):
            mgr.restore({"y": np.zeros(3)})
        assert mgr.all_steps() == [1]


def test_corrupt_error_is_a_value_error():
    """Callers catching ValueError keep working."""
    assert issubclass(CorruptCheckpointError, ValueError)
    with tempfile.TemporaryDirectory() as d:
        p = save_checkpoint(d, 1, {"x": np.zeros(2)})
        shard = [f for f in os.listdir(p) if f.endswith(".npy")][0]
        arr = np.load(os.path.join(p, shard))
        np.save(os.path.join(p, shard), arr + 1.0)
        with pytest.raises(ValueError, match="checksum"):
            load_checkpoint(p, {"x": np.zeros(2)})


def test_manifest_records_trajectory_step_and_checksum():
    with tempfile.TemporaryDirectory() as d:
        p = save_checkpoint(d, 17, {"x": np.arange(3)})
        with open(os.path.join(p, MANIFEST)) as f:
            m = json.load(f)
        assert m["step"] == 17
        assert m["checksum"]
        assert set(m["leaves"]) == {"x"}


# ---------------------------------------------------------------------------
# the format against the reference
# ---------------------------------------------------------------------------


def _cross_tree(archive_cls):
    """A snapshot-shaped tree: nested dicts, a list of archives (one
    empty), 0-d leaves of three dtypes, uint32 key words, a bool mask
    and a list holding ``None``; 12,000 float64s so a leaf spans several
    shards and the checksum reads past the 4096-byte cut."""
    rng = np.random.default_rng(5)
    archives = []
    for rows in (4, 0):
        a = archive_cls(max_size=16)
        if rows:
            a.insert(rng.integers(0, 9, (rows, 7)).astype(np.int32),
                     rng.random((rows, 3)))
        archives.append(a)
    return {
        "carry": {"v": rng.integers(0, 50, (6, 7)).astype(np.int32),
                  "costs": rng.random(6),
                  "best_c": np.float64(0.125),
                  "key": np.asarray([7, 4294967295], np.uint32)},
        "archives": archives,
        "history": rng.random(12000),
        "sweep_done": np.int64(40),
        "fingerprint": np.asarray([2 ** 63 + 5], np.uint64),
        "extras": [np.asarray([True, False]), None, np.int32(-3)],
    }


def _like(archive_cls):
    t = _cross_tree(archive_cls)
    t["archives"] = [archive_cls(max_size=16) for _ in range(2)]
    t["history"] = ELASTIC
    t["sweep_done"] = ELASTIC
    return t


REF = """
import json, os
from repro.checkpoint import ELASTIC, load_checkpoint, save_checkpoint
from repro.pathfinding import ParetoArchive

def manifest(path):
    with open(os.path.join(path, "checkpoint.json")) as f:
        return json.load(f)

ref_dir = str(inp["ref_dir"])
path = save_checkpoint(ref_dir, 40, TREE(ParetoArchive), n_shards=3)
out["ref_manifest"] = np.array(json.dumps(manifest(path)))
# the port's snapshot, loaded by the reference
step, t = load_checkpoint(str(inp["port_path"]), LIKE(ParetoArchive))
out["port/step"] = np.asarray(step)
for k in ("v", "costs", "best_c", "key"):
    out["port/carry/" + k] = np.asarray(t["carry"][k])
for i, a in enumerate(t["archives"]):
    out[f"port/arch/{i}/enc"] = a.encoded
    out[f"port/arch/{i}/vec"] = a.vectors
for k in ("history", "sweep_done", "fingerprint"):
    out["port/" + k] = np.asarray(t[k])
out["port/extras/0"] = np.asarray(t["extras"][0])
out["port/extras/1_is_none"] = np.asarray(t["extras"][1] is None)
out["port/extras/2"] = np.asarray(t["extras"][2])
"""


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    import inspect

    work = tmp_path_factory.mktemp("ref_checkpoint")
    port_path = save_checkpoint(str(work / "port"), 40,
                                _cross_tree(ParetoArchive), n_shards=3)
    src = (inspect.getsource(_cross_tree).replace("_cross_tree", "TREE")
           + inspect.getsource(_like).replace("_like", "LIKE")
           .replace("_cross_tree", "TREE"))
    ref = run_reference(src + REF, {"ref_dir": np.array(str(work / "ref")),
                                    "port_path": np.array(port_path)}, work)
    return dict(ref=ref, ref_path=str(work / "ref" / "step_00000040"),
                port_path=port_path)


def _manifest(path):
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def test_manifests_agree_with_the_reference(cross):
    """Same leaf names in the same order, same dtypes, shapes, shard
    files and slices, same checksum, for the same tree."""
    ref = json.loads(str(cross["ref"]["ref_manifest"]))
    got = _manifest(cross["port_path"])
    assert list(got["leaves"]) == list(ref["leaves"])
    assert got["leaves"] == ref["leaves"]
    assert got["checksum"] == ref["checksum"] and got["step"] == ref["step"]
    assert "archives/0/enc" in got["leaves"]
    assert not any(k.startswith("extras/1") for k in got["leaves"])


def test_reference_snapshot_loads_in_the_port(cross):
    want = _cross_tree(ParetoArchive)
    step, t = load_checkpoint(cross["ref_path"], _like(ParetoArchive))
    assert step == 40
    for k, v in want["carry"].items():
        assert t["carry"][k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(t["carry"][k], v)
    for got, a in zip(t["archives"], want["archives"]):
        assert isinstance(got, ParetoArchive) and got.max_size == 16
        np.testing.assert_array_equal(got.encoded, a.encoded)
        np.testing.assert_array_equal(got.vectors, a.vectors)
    np.testing.assert_array_equal(t["history"], want["history"])
    assert t["sweep_done"].shape == () and int(t["sweep_done"]) == 40
    assert t["fingerprint"].dtype == np.uint64
    np.testing.assert_array_equal(t["fingerprint"], want["fingerprint"])
    np.testing.assert_array_equal(t["extras"][0], want["extras"][0])
    assert t["extras"][1] is None and int(t["extras"][2]) == -3


def test_port_snapshot_loads_in_the_reference(cross):
    ref, want = cross["ref"], _cross_tree(ParetoArchive)
    assert int(ref["port/step"]) == 40
    for k, v in want["carry"].items():
        got = ref["port/carry/" + k]
        assert got.dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(got, v)
    for i, a in enumerate(want["archives"]):
        np.testing.assert_array_equal(ref[f"port/arch/{i}/enc"],
                                      a.encoded.reshape(
                                          ref[f"port/arch/{i}/enc"].shape))
        np.testing.assert_array_equal(ref[f"port/arch/{i}/vec"],
                                      a.vectors.reshape(
                                          ref[f"port/arch/{i}/vec"].shape))
    np.testing.assert_array_equal(ref["port/history"], want["history"])
    assert int(ref["port/sweep_done"]) == 40
    np.testing.assert_array_equal(ref["port/fingerprint"],
                                  want["fingerprint"])
    np.testing.assert_array_equal(ref["port/extras/0"], want["extras"][0])
    assert bool(ref["port/extras/1_is_none"])
    assert int(ref["port/extras/2"]) == -3
