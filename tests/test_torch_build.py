"""The kernel build helper (``repro_torch.kernels._build``) without a
compiler: ``nvcc`` is replaced by a stand-in process that writes the
library file, so what is checked is which builds start and where their
libraries go."""
from pathlib import Path

from repro_torch.kernels import _build


class _FakeNvcc:
    """A finished ``nvcc`` run: writes the ``-o`` file it was given."""

    calls = []

    def __init__(self, cmd, **kwargs):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"")
        _FakeNvcc.calls.append(cmd[-1])
        self.returncode = 0

    def communicate(self):
        return "ptxas info    : Used 8 registers", ""


def _sources(tmp_path, texts):
    paths = []
    for i, text in enumerate(texts):
        src = tmp_path / f"src{i}" / "k.cu"
        src.parent.mkdir()
        src.write_text(text)
        paths.append(src)
    return paths


def _patch(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    _FakeNvcc.calls = []


def test_equal_sources_share_one_build(monkeypatch, tmp_path):
    """Two checkouts' copies of an unchanged source build once, into one
    library, when compiled together."""
    _patch(monkeypatch, tmp_path)
    a, b = _sources(tmp_path, ["// kernel\n", "// kernel\n"])
    libs = _build.compile_sources([a, b])
    assert libs[0] == libs[1] and libs[0].exists()
    assert len(_FakeNvcc.calls) == 1
    assert _build.ptxas_report(a) == ["ptxas info    : Used 8 registers"]


def test_changed_source_builds_anew(monkeypatch, tmp_path):
    _patch(monkeypatch, tmp_path)
    a, b = _sources(tmp_path, ["// kernel\n", "// kernel, edited\n"])
    libs = _build.compile_sources([a, b])
    assert libs[0] != libs[1] and all(so.exists() for so in libs)
    assert len(_FakeNvcc.calls) == 2
    assert _build.compile_sources([a, b]) == libs      # built once
    assert len(_FakeNvcc.calls) == 2
