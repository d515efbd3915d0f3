"""Time the two ways of building the K1 kernel, from nothing built:

  1. the package's route: nvcc on csrc/wavefront_i16.cu alone (plain C
     interface), loaded with ctypes (kernels/build.py);
  2. torch.utils.cpp_extension.load of the same .cu plus a one-function
     pybind11 binding that includes torch/extension.h.

    python3 -m h264_fer_tpu_torch.kernels.time_build

Both build into fresh directories under h264_fer_tpu_torch/_build/ that are
removed afterwards. Prints one JSON line with the seconds of each route
(null for a route that could not build, with the reason).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import tempfile
import time

from . import build

BINDING = r"""
#include <torch/extension.h>
#include <cuda_runtime.h>
#include <cstdint>

extern "C" int wavefront_i16_frame(const uint8_t*, const uint8_t*,
                                   const uint8_t*, const int32_t*,
                                   const int32_t*, uint8_t*, uint8_t*,
                                   uint8_t*, const int32_t*, int32_t*, int,
                                   int, int, int, const int*, int,
                                   cudaStream_t, int*);

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("frame_fn", []() {
    return reinterpret_cast<int64_t>(&wavefront_i16_frame);
  });
}
"""


def time_ctypes(root: pathlib.Path) -> float:
    build.BUILD_DIR = root / "ctypes"
    t0 = time.perf_counter()
    build.load("wavefront_i16")
    return time.perf_counter() - t0


def time_cpp_extension(root: pathlib.Path) -> float:
    from torch.utils import cpp_extension

    if not cpp_extension.is_ninja_available():
        raise RuntimeError("ninja is not installed: cpp_extension.load cannot build")
    out = root / "cpp_extension"
    out.mkdir()
    binding = out / "binding.cpp"
    binding.write_text(BINDING)
    t0 = time.perf_counter()
    mod = cpp_extension.load(
        name="wavefront_i16_ext",
        sources=[str(build.CSRC / "wavefront_i16.cu"), str(binding)],
        extra_cuda_cflags=["-gencode", "arch=compute_90a,code=sm_90a", "-O3"],
        build_directory=str(out))
    seconds = time.perf_counter() - t0
    if not mod.frame_fn():
        raise RuntimeError("the extension's kernel entry point is null")
    return seconds


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="time_build-", dir=build.BUILD_DIR))
    result = {"card": card[0] if card else None}
    try:
        for key, fn in (("ctypes_s", time_ctypes),
                        ("cpp_extension_s", time_cpp_extension)):
            try:
                result[key] = fn(root)
            except Exception as exc:  # report the route that failed, run the other
                result[key] = None
                result[key.replace("_s", "_error")] = f"{type(exc).__name__}: {exc}"[:500]
            print(f"{key}: {result[key]}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
