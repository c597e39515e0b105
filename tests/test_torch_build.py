"""PyTorch port: the kernel build cache (``kernels/build.py``) on the CPU.

A library is cached under a key of its source, the ``csrc/*.cuh`` headers
that the source includes, and its flags; an edited header must give a new
library path (so a stale library is never loaded), and a header a source
does not include must leave that source's path alone.  The sources are
copied to a temporary ``csrc`` (no ``nvcc`` runs: only the paths are
computed).
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

SPLIT = "split_mma.cuh"
USERS = ("flash_attention", "ssd_scan")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small shapes run on one intra-op thread: under the suite's
    parallel workers torch's default pool (one thread per core in every
    worker) oversubscribes the cores and its waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return copy


@pytest.mark.parametrize("name", build.SOURCES)
def test_headers_are_the_included_cuh(csrc, name):
    want = [csrc / SPLIT] if name in USERS else []
    assert build.headers(name) == want


@pytest.mark.parametrize("name", USERS)
def test_library_path_changes_with_an_included_header(csrc, name):
    before = build.library_path(name)
    assert before.parent == build.BUILD_DIR
    header = csrc / SPLIT
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(name)
    assert after != before
    header.write_text(header.read_text()[:-len("\n// edited\n")])
    assert build.library_path(name) == before


@pytest.mark.parametrize("name", ["vrl_update", "comm_update",
                                  "leaf_update"])
def test_library_path_ignores_a_header_it_does_not_include(csrc, name):
    before = build.library_path(name)
    header = csrc / SPLIT
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) == before
    source = csrc / f"{name}.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert build.library_path(name) != before
