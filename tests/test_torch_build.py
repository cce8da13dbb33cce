"""The port's kernel build logic, on the CPU (no nvcc is called here)."""
import shutil

import pytest

from smart_crossover_tpu_torch import _build, kernel_launch_counts
from smart_crossover_tpu_torch import reset_kernel_launch_counts


@pytest.fixture
def src_copy(tmp_path, monkeypatch):
    """A copy of csrc/ and an empty build directory under tmp_path."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_name_follows_the_sources(src_copy):
    """A changed source gets a new library name, so a stale build is never
    loaded."""
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR
    (src_copy / "sinkhorn.cu").write_text(
        (src_copy / "sinkhorn.cu").read_text() + "\n// changed\n")
    assert _build.library_path() != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_name_follows_each_source(src_copy, name):
    before = _build.library_path()
    (src_copy / name).write_text((src_copy / name).read_text() + "\n// x\n")
    assert _build.library_path() != before


def test_every_kernel_has_a_source_signature_and_counter():
    assert _build.SOURCES == ("sinkhorn.cu", "transport_simplex_mega.cu",
                              "pdhg_cluster.cu")
    for name in _build.LAUNCHES:
        assert f"scx_{name}" in _build._SIGNATURES
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()


def test_existing_library_is_reused(src_copy, monkeypatch):
    lib = _build.library_path()
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc must not run when the library exists")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build() == lib


def test_missing_nvcc_raises_and_leaves_nothing(src_copy, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not _build.BUILD_DIR.exists() or \
        not any(_build.BUILD_DIR.iterdir())


def test_failed_compile_raises_and_leaves_nothing(src_copy, monkeypatch,
                                                  tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert list(_build.BUILD_DIR.iterdir()) == []


def test_cuda_error_codes_raise():
    _build.check(0, "fn")
    with pytest.raises(RuntimeError, match="fn: CUDA error 700"):
        _build.check(700, "fn")


def test_launch_counts_reset():
    _build.LAUNCHES["sinkhorn_fused"] += 3
    assert kernel_launch_counts()["sinkhorn_fused"] >= 3
    reset_kernel_launch_counts()
    assert kernel_launch_counts() == {
        "sinkhorn_fused": 0, "transport_simplex_mega": 0, "pdhg_chunk": 0,
        "halpern_chunk": 0, "pdhg_batched": 0}
