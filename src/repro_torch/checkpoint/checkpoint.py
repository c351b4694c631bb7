"""Sharded checkpointing: per-leaf ``.npy`` shards + a JSON manifest.

The counterpart of :mod:`repro.checkpoint.checkpoint`, on disk byte for
byte the same format, so a checkpoint written by either package loads in
the other:

  * Every tree leaf is saved as one or more ``.npy`` shard files, split
    along its largest axis into ``n_shards`` pieces. The manifest stores
    only the logical array, so restore reassembles it whatever the shard
    count was.
  * The manifest (``checkpoint.json``) records the step, each leaf's
    dtype, shape and shard files, and a checksum: SHA-256 over the first
    4096 bytes of every shard, in manifest order. Writes are atomic (a
    tmp directory renamed into place), so a failure mid-save never
    corrupts the newest valid checkpoint.
  * Leaves are named as ``jax.tree_util`` names them and stored in its
    flattening order: dict keys sorted, list and tuple items by index,
    the path joined with ``/`` (``"carry/v"``, ``"archives/0/vec"``);
    ``None`` holds no leaf. :func:`_leaf_paths` is that flattener for
    nested dicts, lists and tuples (anything else is a leaf).
  * ``CheckpointManager`` keeps the last ``keep`` checkpoints and finds
    the newest valid one on restart; ``restore`` prunes directories whose
    payload fails verification and falls back to the next-newest step.
  * Trees may hold *checkpointable objects*, anything with
    ``checkpoint_arrays() -> dict[str, ndarray]`` and
    ``from_checkpoint_arrays(dict) -> object`` (such as
    :class:`repro_torch.pathfinding.pareto.ParetoArchive`). They are
    expanded to their array dict on save and rebuilt on load, with the
    saved shapes (elastic). The :data:`ELASTIC` sentinel marks any other
    template leaf whose shape comes from the manifest.

Leaves are saved from and come back as numpy arrays of the manifest's
dtype (0-d arrays for scalars); moving them to and from a torch device
is the caller's business.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST = "checkpoint.json"


class CorruptCheckpointError(ValueError):
    """The checkpoint payload is unreadable or fails verification
    (missing or truncated shard, unreadable manifest, checksum mismatch),
    as opposed to a valid checkpoint that does not fit the template
    (missing leaf, shape mismatch), which raises ``KeyError`` /
    ``ValueError`` and is never pruned."""


class _Elastic:
    """Template sentinel: restore this leaf with the manifest's shape and
    dtype instead of requiring the template's."""

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "ELASTIC"


ELASTIC = _Elastic()


def _is_checkpointable(x: Any) -> bool:
    return (hasattr(x, "checkpoint_arrays")
            and hasattr(x, "from_checkpoint_arrays"))


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(name, child)`` pairs of a container node in ``jax.tree_util``'s
    order, or ``None`` for a leaf: a dict's keys sorted, a list's or
    tuple's items by index; ``None`` has no children."""
    if node is None:
        return []
    if type(node) is dict:
        return [(str(k), node[k]) for k in sorted(node)]
    if type(node) in (list, tuple):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf (checkpointable objects count as
    leaves), with the containers rebuilt."""
    if _is_checkpointable(tree) or _children(tree) is None:
        return fn(tree)
    return _rebuild(tree, lambda v, _: _map(fn, v))


def _rebuild(node: Any, fn: Callable[[Any, Any], Any]) -> Any:
    """A container node with each child ``v`` (at key or index ``k``)
    replaced by ``fn(v, k)``; ``None`` stays ``None``."""
    if node is None:
        return None
    if type(node) in (list, tuple):
        return type(node)(fn(v, i) for i, v in enumerate(node))
    return {k: fn(v, k) for k, v in node.items()}


def _expand_for_save(tree: Any) -> Any:
    """Replace checkpointable objects with their array dicts (the dict
    becomes a subtree, so each array gets its own manifest leaf)."""
    return _map(lambda leaf: (dict(leaf.checkpoint_arrays())
                              if _is_checkpointable(leaf) else leaf), tree)


def _expand_for_load(tree: Any) -> Any:
    """Template twin of :func:`_expand_for_save`: every object array is
    marked :data:`ELASTIC` (its saved shape wins over the template's)."""
    return _map(lambda leaf: ({k: ELASTIC for k in leaf.checkpoint_arrays()}
                              if _is_checkpointable(leaf) else leaf), tree)


def _collapse(like: Any, restored: Any) -> Any:
    """Rebuild objects: where ``like`` holds a checkpointable object,
    ``restored`` holds its array-dict subtree."""
    if _is_checkpointable(like):
        return like.from_checkpoint_arrays(restored)
    if _children(like) is None:
        return restored
    return _rebuild(like, lambda v, k: _collapse(v, restored[k]))


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its ``/``-joined path, in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for name, child in kids:
        out.extend(_leaf_paths(child, f"{prefix}/{name}" if prefix
                               else name))
    return out


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in flattening
    order, by the items of ``leaves``."""
    if _children(like) is None:
        return next(leaves)
    if type(like) is dict:
        # children are consumed in flattening (sorted-key) order
        done = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: done[k] for k in like}
    return _rebuild(like, lambda v, _: _unflatten(v, leaves))


def _shard_slices(shape: Tuple[int, ...], n_shards: int):
    """Split along the largest axis into up to n_shards contiguous slices."""
    if not shape or n_shards <= 1:
        return [tuple(slice(None) for _ in shape)]
    axis = int(np.argmax(shape))
    n = min(n_shards, shape[axis])
    edges = np.linspace(0, shape[axis], n + 1, dtype=int)
    slices = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi > lo:
            s = [slice(None)] * len(shape)
            s[axis] = slice(int(lo), int(hi))
            slices.append(tuple(s))
    return slices


def save_checkpoint(directory: str, step: int, tree: Any,
                    n_shards: int = 8) -> str:
    """Atomic save of a tree of arrays (numpy arrays or scalars). Returns
    the checkpoint path.

    The tree may contain checkpointable objects (see module docstring);
    they are expanded to their array dicts before writing."""
    tree = _expand_for_save(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "time": 0.0}
    manifest["time"] = time.time()
    digest = hashlib.sha256()
    for name, leaf in _leaf_paths(tree):
        arr = np.asarray(leaf)
        entry = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                 "shards": []}
        for i, sl in enumerate(_shard_slices(arr.shape, n_shards)):
            fname = f"{name.replace('/', '.')}.{i}.npy"
            piece = np.ascontiguousarray(arr[sl])
            np.save(os.path.join(tmp, fname), piece)
            digest.update(piece.tobytes()[:4096])
            entry["shards"].append({
                "file": fname,
                "slices": [[s.start, s.stop] if s.start is not None
                           or s.stop is not None else None
                           for s in sl],
            })
        manifest["leaves"][name] = entry
    manifest["checksum"] = digest.hexdigest()
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(path: str, like: Any) -> Tuple[int, Any]:
    """Restore into the structure of ``like``; returns ``(step, tree)``.

    Template leaves that are :data:`ELASTIC` (or arrays of a
    checkpointable object) take their shape and dtype from the manifest.
    Unreadable payloads raise :class:`CorruptCheckpointError`; a valid
    checkpoint that does not fit the template raises ``KeyError`` /
    ``ValueError``."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        leaves = manifest["leaves"]
    except (OSError, ValueError, KeyError) as e:
        raise CorruptCheckpointError(
            f"checkpoint {path}: unreadable manifest ({e})") from e

    # read and digest every manifest leaf in manifest (= save) order
    # before matching the template: the checksum covers the whole
    # payload, so a template asking for a subset of the saved leaves
    # must not skew the digest into a false corruption verdict (restore
    # prunes on corruption)
    digest = hashlib.sha256()
    arrays: Dict[str, np.ndarray] = {}
    for name, entry in leaves.items():
        arr = np.empty(entry["shape"], dtype=np.dtype(entry["dtype"]))
        for sh in entry["shards"]:
            try:
                piece = np.load(os.path.join(path, sh["file"]))
            except (OSError, ValueError) as e:
                raise CorruptCheckpointError(
                    f"checkpoint {path}: bad shard {sh['file']} ({e})"
                ) from e
            sl = tuple(slice(None) if s is None else slice(s[0], s[1])
                       for s in sh["slices"])
            try:
                arr[sl if sl else ...] = piece
            except ValueError as e:
                raise CorruptCheckpointError(
                    f"checkpoint {path}: shard {sh['file']} does not fit "
                    f"its manifest slice ({e})") from e
            digest.update(piece.tobytes()[:4096])
        arrays[name] = arr
    if manifest.get("checksum") and manifest["checksum"] != digest.hexdigest():
        raise CorruptCheckpointError(
            f"checkpoint {path} checksum mismatch (corrupt?)")

    like_x = _expand_for_load(like)
    out = []
    for name, leaf in _leaf_paths(like_x):
        arr = arrays.get(name)
        if arr is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        if leaf is not ELASTIC and list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs "
                f"model {np.shape(leaf)}")
        out.append(arr)
    restored = _unflatten(like_x, iter(out))
    return manifest["step"], _collapse(like, restored)


class CheckpointManager:
    """Rotating checkpoint directory with newest-valid discovery."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 8):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, MANIFEST)):
                    steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def latest(self) -> Optional[str]:
        steps = self.all_steps()
        if not steps:
            return None
        return self.step_path(steps[-1])

    def save(self, step: int, tree: Any) -> str:
        path = save_checkpoint(self.directory, step, tree, self.n_shards)
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.step_path(s), ignore_errors=True)
        return path

    def restore(self, like: Any) -> Tuple[int, Any]:
        """Restore the newest *valid* checkpoint.

        A directory whose payload fails verification (torn copy,
        truncated shard, checksum mismatch) is pruned and the next-newest
        step is tried. A structural mismatch with ``like`` (missing leaf,
        shape mismatch) raises at once: that is a caller bug, not
        corruption."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            path = self.step_path(s)
            try:
                return load_checkpoint(path, like)
            except CorruptCheckpointError as e:
                last_err = e
                shutil.rmtree(path, ignore_errors=True)
        raise FileNotFoundError(
            f"no valid checkpoint in {self.directory} "
            f"(every step failed verification; last: {last_err})")
