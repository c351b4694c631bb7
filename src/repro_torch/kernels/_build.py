"""Build and load of the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface. ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root, named by the source's stem and a hash of its
contents, so an edited source builds anew and an unchanged one is built
once. The compiler's resource report (``-Xptxas -v``) is kept beside the
library as ``<name>.log``. The library is loaded with ``ctypes``.

:func:`compile_sources` starts one ``nvcc`` per source, all at once, and
waits for them; :func:`load` compiles one source if needed and loads it.
A failed build raises.

``ctypes`` calls are invisible to torch's dispatcher, so a wrapper
reports each call's work to the counters in :data:`COUNTERS` through
:func:`counted`. The list is empty unless a step is being counted
(``repro_torch.analysis.counting.OpCounter`` adds itself while it is
entered), and a wrapper then skips the report with one check.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}

# The active work counters, outermost first. Each has
# ``enter_kernel(name, ops, nbytes)`` and ``exit_kernel()``.
COUNTERS: List = []


@contextlib.contextmanager
def counted(name: str, ops: int, nbytes: int):
    """Report one call of the hand-written kernel ``name`` (``ops``
    operations, ``nbytes`` bytes, by its formula) to every counter in
    :data:`COUNTERS`, and hide from them the aten ops run inside the
    block: the plain version on the CPU, empty outputs on ``meta``,
    allocations around the launch on cuda."""
    counters = list(COUNTERS)
    for c in counters:
        c.enter_kernel(name, ops, nbytes)
    try:
        yield
    finally:
        for c in counters:
            c.exit_kernel()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives."""
    tag = hashlib.sha1(Path(source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}_{tag}.so"


def compile_sources(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; return the library paths in source order.
    Sources of equal contents share one library and one build."""
    sources = [Path(s) for s in sources]
    libs = [library_path(s) for s in sources]
    running = []
    for src, so in zip(sources, libs):
        if so.exists() or any(so == r[1] for r in running):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}) building "
                          f"{src}:\n{err}")
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path, configure: Callable[[ctypes.CDLL], None]
         ) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if needed.
    ``configure`` sets the ``argtypes``/``restype`` of its functions."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        (so,) = compile_sources([source])
        lib = ctypes.CDLL(str(so))
        configure(lib)
        _loaded[source] = lib
    return lib


def ptxas_report(source: Path) -> List[str]:
    """The ``ptxas info`` lines of the build log of ``source``, with the
    stack and spill line that follows each function's properties."""
    log = library_path(source).with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if "ptxas info" in ln or "bytes spill" in ln]
