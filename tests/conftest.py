"""Pytest config. NOTE: never set --xla_force_host_platform_device_count
here — smoke tests and benches must see 1 device; only launch/dryrun.py
(as an entry point) and explicit subprocess tests use fake device counts.

When ``hypothesis`` is not installed (it is a dev dependency, see
requirements-dev.txt), a deterministic fixed-example fallback is
registered under the same module name so the property tests still
collect and run.
"""
import os
import sys

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_fallback

    sys.modules["hypothesis"] = _hypothesis_fallback


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device subprocess tests and jit-compile-heavy device "
        "searches (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips without one (the port's CUDA "
        "kernels have no CPU mode)")
