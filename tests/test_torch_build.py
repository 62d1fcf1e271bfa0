"""The kernels' build: what the library hash covers.

``build._digest`` names each kernel's library, so whatever the compiler
reads must move it: the source, the headers beside it, the shared headers
under ``kernels/common/`` (``hopper.cuh``, included by the wgmma kernels)
and the flags.  Nothing is compiled here (this runs on the CPU).
"""

import pytest

from repro_torch.kernels import build


def test_every_kernel_source_is_found_and_common_is_no_kernel():
    names = set(build.sources())
    assert {"gemm", "flash_attention", "tree_sum", "tree_reduce",
            "paged_attention", "paged_mla_attention"} <= names
    assert (build.COMMON_DIR / "hopper.cuh").is_file()
    assert "-I" in build.NVCC_FLAGS and \
        str(build.COMMON_DIR) in build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["gemm", "flash_attention", "tree_sum"])
def test_digest_changes_with_a_shared_header(tmp_path, monkeypatch, name):
    common = tmp_path / "common"
    common.mkdir()
    header = common / "hopper.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "COMMON_DIR", common)
    src = build.sources()[name]
    first = build._digest(src)
    assert build._digest(src) == first
    header.write_text("// two\n")
    second = build._digest(src)
    assert second != first
    (common / "more.cuh").write_text("// a new shared header\n")
    assert build._digest(src) not in (first, second)


def test_digest_changes_with_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "COMMON_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = build._digest(src)
    src.write_text("// b\n")
    assert build._digest(src) != first
