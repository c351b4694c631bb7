"""Reference runner for the torch port's tests (holds no tests itself).

The port (``src/repro_torch``) is held against the JAX package
(``src/repro``), which cannot be imported as it stands here: its
``DesignSpace``/``Objective`` dataclasses take an unhashable ``TechDB`` as
a plain default (a ``ValueError`` on Python 3.11+), it imports
``jax.experimental.enable_x64``, which jax 0.9 removed, and its goldens
hold only under ``jax_threefry_partitionable=False``. The runner
therefore executes the reference in a fresh subprocess with three shims:

* ``jax.experimental.enable_x64`` aliased to ``jax.enable_x64``;
* ``TechDB.__hash__ = object.__hash__`` while ``repro.pathfinding`` is
  imported, restored afterwards;
* ``jax_threefry_partitionable=False``.

A subprocess keeps the shims out of the pytest worker, where they would
leak into the JAX package's own test files (which share workers) and
turn their failures into passes.

Use: a test module builds its inputs with numpy from a seed, writes a
script body that reads ``inp`` (a dict of arrays) and fills ``out`` (a
dict of arrays), and calls :func:`run_reference` once from a
module-scoped fixture.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from typing import Any, Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

_PREAMBLE = """\
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
import jax.experimental


def _enable_x64(new_val=True):
    return jax.enable_x64(new_val)


jax.experimental.enable_x64 = _enable_x64
jax.config.update("jax_threefry_partitionable", False)
from repro.core.techdb import TechDB
TechDB.__hash__ = object.__hash__
import repro.pathfinding  # noqa: E402
TechDB.__hash__ = None
inp = dict(np.load(sys.argv[1], allow_pickle=False))
out = {}
"""

_EPILOGUE = """
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def run_reference(body: str, inputs: Optional[Dict[str, np.ndarray]],
                  workdir, timeout: float = 240.0,
                  env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, np.ndarray]:
    """Run ``body`` against the reference package in a subprocess and
    return the ``out`` dict it filled. ``env`` adds variables to the
    subprocess's environment (``XLA_FLAGS``, read before jax starts)."""
    workdir = str(workdir)
    in_path = os.path.join(workdir, "ref_in.npz")
    out_path = os.path.join(workdir, "ref_out.npz")
    script = os.path.join(workdir, "ref_run.py")
    np.savez(in_path, **(inputs or {"_": np.zeros(0)}))
    with open(script, "w") as f:
        f.write(_PREAMBLE + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, script, in_path, out_path], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference run failed (rc={proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    return dict(np.load(out_path, allow_pickle=False))


# Reference-side helper for pytrees, prepended to a body that saves one:
# ``flat(tree, "p/")`` turns nested dicts of arrays into "p/a/b" keys,
# which np.savez can hold.
FLAT = """
def flat(tree, pre):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flat(v, pre + k + "/"))
        else:
            res[pre + k] = np.asarray(v)
    return res
"""


def nest(arrays: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """The nested dict under ``prefix`` of "prefix/a/b"-keyed arrays (the
    inverse of the reference-side ``flat``)."""
    out: Dict[str, Any] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out
