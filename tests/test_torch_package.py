"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` (with
``tests/test_torch_ties.py``, which it loads) and the port's scripts
(``scripts/torch_*.py``) import neither jax nor anything of the JAX
package ``repro``."""
import os
import re
import subprocess
import sys

import pytest

from test_torch_support import REPO, SRC

PKG = os.path.join(SRC, "repro_torch")
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.MULTILINE)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tests", "test_torch_ties.py")  # chip_smoke's
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(scripts, f)


def _modules():
    for path in _sources():
        rel = os.path.relpath(path, SRC)
        if rel.startswith(".."):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_reference(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, f"{path} imports {hits}"


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a CUDA device the smoke script exits non-zero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
