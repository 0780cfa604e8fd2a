"""`kernels/build.py` names each library by a hash of what its compile
reads: the `.cu` source, every header beside it and the flags. A library
built before an edit of the shared header must not be loaded after it.
Runs on the CPU: nothing is compiled."""

import shutil

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_torch.kernels import build  # noqa: E402

NAMES = ("bcsr_spmm", "bcsr_super_spmm", "ell_spmm")


@pytest.fixture
def src(tmp_path, monkeypatch):
    """A copy of the kernel sources that `build` reads instead."""
    copy = tmp_path / "kernels"
    shutil.copytree(build._SRC_DIR, copy,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    monkeypatch.setattr(build, "_SRC_DIR", copy)
    return copy


def _paths():
    return {name: build._library_path(name) for name in NAMES}


def test_library_path_is_stable(src):
    assert _paths() == _paths()
    assert all(p.parent == build.BUILD_DIR for p in _paths().values())


@pytest.mark.parametrize("edit", ["shared header", "new header"])
def test_library_path_follows_the_headers(src, edit):
    before = _paths()
    if edit == "shared header":
        header = src / "spmm_tc.cuh"
        assert header.exists()
        header.write_text(header.read_text() + "\n// edited\n")
    else:
        (src / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[name] != before[name] for name in NAMES)


def test_library_path_follows_its_own_source_only(src):
    before = _paths()
    cu = src / "bcsr_spmm.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    after = _paths()
    assert after["bcsr_spmm"] != before["bcsr_spmm"]
    assert after["bcsr_super_spmm"] == before["bcsr_super_spmm"]
    assert after["ell_spmm"] == before["ell_spmm"]


def test_ell_library_path_follows_its_source(src):
    # the ELL kernel is a source of its own, built at first use like the
    # other two: its edit rebuilds it alone
    before = _paths()
    cu = src / "ell_spmm.cu"
    assert cu.exists()
    cu.write_text(cu.read_text() + "\n// edited\n")
    after = _paths()
    assert after["ell_spmm"] != before["ell_spmm"]
    assert all(after[name] == before[name] for name in NAMES
               if name != "ell_spmm")
