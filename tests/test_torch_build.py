"""The kernel build step with a stand-in nvcc (no CUDA toolkit here): one
compile per source, results named by content hash (the source and the
headers it includes), failures raised with the compiler's output,
up-to-date libraries not rebuilt."""

import os
import stat

import pytest
import torch

from h264_fer_tpu_torch.kernels import build

torch.set_num_threads(1)

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: writes the file named after -o, fails on a source
# that contains the word BROKEN
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
if grep -q BROKEN "$src"; then echo "error: broken source $src"; exit 2; fi
echo "ptxas info: compiled $src"
echo lib > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_build_all_compiles_each_source_once(fake_toolchain):
    (fake_toolchain / "a.cu").write_text("kernel a")
    (fake_toolchain / "b.cu").write_text("kernel b")
    first = {n: build.compile_source(n) for n in ("a", "b")}
    for name, (lib, log) in first.items():
        assert lib.exists() and lib.name.startswith(f"lib{name}-")
        assert f"compiled {fake_toolchain / (name + '.cu')}" in log
    assert first["a"][0] != first["b"][0]
    again = build.compile_source("a")
    assert again == (first["a"][0], "")  # up to date: no compile
    (fake_toolchain / "a.cu").write_text("kernel a, changed")
    changed = build.compile_source("a")[0]
    assert changed != first["a"][0] and changed.exists()


def test_changed_header_rebuilds_its_includers(fake_toolchain):
    (fake_toolchain / "common.cuh").write_text("int x;")
    (fake_toolchain / "k.cuh").write_text('#pragma once\n#include "common.cuh"\n')
    (fake_toolchain / "k.cu").write_text('#include <cstdint>\n#include "k.cuh"\nkernel k')
    (fake_toolchain / "other.cu").write_text("kernel other")
    assert [f.name for f in build.includes(fake_toolchain / "k.cu")] == [
        "k.cu", "k.cuh", "common.cuh"]
    first = build.compile_source("k")[0]
    other = build.compile_source("other")[0]
    (fake_toolchain / "common.cuh").write_text("int y;")
    lib, log = build.compile_source("k")
    assert lib != first and lib.exists()
    assert f"compiled {fake_toolchain / 'k.cu'}" in log
    assert build.compile_source("k") == (lib, "")
    assert build.compile_source("other") == (other, "")  # does not include it


def test_build_failure_raises_with_compiler_output(fake_toolchain):
    (fake_toolchain / "bad.cu").write_text("BROKEN")
    with pytest.raises(RuntimeError, match="broken source"):
        build.compile_source("bad")
    assert os.listdir(build.BUILD_DIR) == []  # no partial library left


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
