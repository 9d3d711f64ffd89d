"""The port's kernel build cache (seldon_core_tpu_torch.ops._build): the
library name follows the bytes of the source and of every header beside
it, so an edited header cannot load a stale library. No nvcc needed."""

from seldon_core_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nint f() { return g(); }\n')
    (csrc / "h.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_library_path_follows_header_bytes(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("k.cu")
    assert before == _build.library_path("k.cu")  # stable for the same bytes
    (csrc / "h.cuh").write_text("inline int g() { return 2; }\n")
    after = _build.library_path("k.cu")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("k-")


def test_library_path_follows_new_header_and_source(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = _build.library_path("k.cu")
    (csrc / "extra.cuh").write_text("// another header\n")
    second = _build.library_path("k.cu")
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\nint f() { return -g(); }\n')
    assert _build.library_path("k.cu") not in (first, second)


def test_library_path_ignores_other_files(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = _build.library_path("k.cu")
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build.library_path("k.cu") == first
