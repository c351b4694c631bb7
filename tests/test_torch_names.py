"""Public names: each subpackage of the port exports (``__all__``) every
name its twin in the reference exports, so code written against the
reference does not fail on the port at import. The port may export
more.

The reference's ``__init__.py`` files are read with ``ast`` (nothing of
the reference is imported). The allowed differences:

- renames: ``*_ref`` -> ``*_plain`` (the port's plain torch versions),
  ``prefix_select_gather`` -> ``prefix_select`` and
  ``non_dominated_mask_jnp`` -> ``non_dominated_mask_torch``;
- one omission, ``kernels.wkv6_ref_vmapped``: it is ``jax.vmap`` of
  ``wkv6_ref`` over rows, and ``wkv6_plain`` already takes the batched
  (G, T, D) and (B, T, H, D) layouts.

The reference's ``analysis`` and ``launch`` have no ``__all__``: their
names are those their ``__init__.py`` imports, and the port exports
each of them too.
"""
import ast
import importlib
import os

import pytest

from test_torch_support import SRC

SUBPACKAGES = ("checkpoint", "configs", "core", "data", "kernels", "optim",
               "pathfinding", "runtime", "serving")
RENAMES = {"prefix_select_gather": "prefix_select",
           "non_dominated_mask_jnp": "non_dominated_mask_torch"}
OMITTED = {"kernels": {"wkv6_ref_vmapped"}}


def _reference_all(pkg):
    """The reference subpackage's ``__all__``, or None without one."""
    path = os.path.join(SRC, "repro", pkg, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _reference_imports(pkg):
    """The names the reference subpackage's ``__init__.py`` imports."""
    path = os.path.join(SRC, "repro", pkg, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def _port_name(name):
    if name in RENAMES:
        return RENAMES[name]
    if name.endswith("_ref"):
        return name[:-len("_ref")] + "_plain"
    return name


def test_every_reference_subpackage_with_names_is_covered():
    pkgs = sorted(d for d in os.listdir(os.path.join(SRC, "repro"))
                  if os.path.exists(os.path.join(SRC, "repro", d,
                                                 "__init__.py")))
    assert sorted(p for p in pkgs if _reference_all(p)) == \
        sorted(SUBPACKAGES)


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_port_exports_the_reference_names(pkg):
    mod = importlib.import_module(f"repro_torch.{pkg}")
    wanted = [_port_name(n) for n in _reference_all(pkg)
              if n not in OMITTED.get(pkg, ())]
    missing = [n for n in wanted if n not in mod.__all__]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    assert all(hasattr(mod, n) for n in mod.__all__)


@pytest.mark.parametrize("pkg", ("analysis", "launch"))
def test_port_exports_the_names_the_reference_imports(pkg):
    wanted = _reference_imports(pkg)
    assert wanted and _reference_all(pkg) is None
    mod = importlib.import_module(f"repro_torch.{pkg}")
    missing = [n for n in wanted if n not in mod.__all__]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    assert all(hasattr(mod, n) for n in mod.__all__)
