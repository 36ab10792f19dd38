"""The kernel build's cache key (``repro_torch.kernels._build``).

A library's file name carries a digest of its source, of every header in
``csrc/`` and of the flags, so that an edited header (``hopper.cuh``, which
two sources include) rebuilds every library and never loads a stale one.
No ``nvcc`` is needed: only paths are computed.
"""
from repro_torch.kernels import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (csrc / "b.cu").write_text("int b;\n")
    (csrc / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_editing_a_header_changes_every_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    (csrc / "shared.cuh").write_text("#pragma once\nint c;\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_library_path_follows_sources_and_headers_only(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    a, b = _build.library_path("a"), _build.library_path("b")
    assert a == _build.library_path("a") and a != b
    (csrc / "notes.txt").write_text("not compiled\n")
    assert _build.library_path("a") == a
    (csrc / "extra.cuh").write_text("#pragma once\n")    # a new header
    assert _build.library_path("a") != a
    (csrc / "b.cu").write_text("int b2;\n")
    assert _build.library_path("b") != b
