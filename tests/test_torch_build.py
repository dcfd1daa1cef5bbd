"""The name of each native build (openmvg_torch/utils/build.py::build_tag)
covers every header its source may include, so that a changed header
never loads a library built from the old one.  No compiler is needed."""

import os
import shutil

import pytest

from openmvg_torch.utils import build

FLAGS = ["-O3", "-shared"]


def _tree(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (d / "shared.cuh").write_text("#pragma once\nconstexpr int kN = 1;\n")
    (d / "other.cu").write_text("__global__ void o() {}\n")
    return str(d)


@pytest.mark.parametrize("edit", ["header_bytes", "new_header", "source", "flags"])
def test_tag_changes_with_what_the_build_reads(tmp_path, edit):
    d = _tree(tmp_path)
    before = build.build_tag("k.cu", FLAGS, d)
    assert before == build.build_tag("k.cu", FLAGS, d)      # stable
    flags = FLAGS
    if edit == "header_bytes":
        with open(os.path.join(d, "shared.cuh"), "a") as f:
            f.write("constexpr int kM = 2;\n")
    elif edit == "new_header":
        with open(os.path.join(d, "extra.cuh"), "w") as f:
            f.write("#pragma once\n")
    elif edit == "source":
        with open(os.path.join(d, "k.cu"), "a") as f:
            f.write("// note\n")
    else:
        flags = FLAGS + ["-lineinfo"]
    assert build.build_tag("k.cu", flags, d) != before


def test_tag_ignores_other_sources(tmp_path):
    d = _tree(tmp_path)
    before = build.build_tag("k.cu", FLAGS, d)
    with open(os.path.join(d, "other.cu"), "a") as f:
        f.write("// another kernel's change\n")
    assert build.build_tag("k.cu", FLAGS, d) == before


def test_both_kernel_libraries_follow_the_shared_k2_header(tmp_path):
    """seg_sum.cu and smatvec.cu include csrc/seg_sum.cuh; a change to it
    renames both builds."""
    d = str(tmp_path / "csrc")
    shutil.copytree(build.CSRC, d)
    assert os.path.exists(os.path.join(d, "seg_sum.cuh"))
    for src in ("seg_sum.cu", "smatvec.cu"):
        with open(os.path.join(d, src)) as f:
            assert '#include "seg_sum.cuh"' in f.read()
    before = {s: build.build_tag(s, build.NVCC_FLAGS, d) for s in ("seg_sum.cu", "smatvec.cu")}
    assert before == {s: build.build_tag(s, build.NVCC_FLAGS) for s in before}
    with open(os.path.join(d, "seg_sum.cuh"), "a") as f:
        f.write("\n")
    for s, tag in before.items():
        assert build.build_tag(s, build.NVCC_FLAGS, d) != tag
