"""Build the package's CUDA kernels from the sources in kernels/csrc.

`csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
sm_90a into `h264_fer_tpu_torch/_build/lib<name>-<hash>.so`, then loaded
with ctypes. The file name carries a hash of the source, of every
csrc header it includes (`#include "x.cuh"`, followed transitively) and of
the flags, so a changed source or shared header is rebuilt and a stale
library is never loaded. No PyTorch
header is compiled, so a build takes seconds (PERF.md compares it with
torch.utils.cpp_extension.load, timed by kernels/time_build.py).

`compile_host_source` builds a host C++ source with a plain C interface
(the native slice decoder, native/decoder_native.cpp) the same way with
g++ into the same cache.

Nothing here runs at import: the first launch of a kernel builds it. A
missing compiler or a failed compile raises; there is no fallback. `function`
and `check_tensor` are what every kernel wrapper uses to bind its C entry
point and to refuse a tensor the kernel does not take; `launch` runs the
entry points that loop over dependent launches and count them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def includes(src: pathlib.Path) -> list[pathlib.Path]:
    """src and the files it includes with quotes, transitively (paths
    relative to the including file), each once, src first."""
    found, todo = [], [src]
    while todo:
        f = todo.pop(0)
        if f not in found:
            found.append(f)
            todo += [f.parent / m for m in _INCLUDE.findall(f.read_text())]
    return found


def gxx() -> str:
    """Path of g++ on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native decoder cannot be built")
    return found


def _compile(src: pathlib.Path, compiler: str, flags) -> tuple[pathlib.Path, str]:
    """Compile src with `compiler` and `flags` into BUILD_DIR unless its
    library is up to date. Returns (library path, compiler output; empty
    when nothing was compiled)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in includes(src):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build failed: {src.name}: {pathlib.Path(compiler).name} "
                           f"exit {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stdout


def compile_source(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu unless its library is up to date. Returns
    (library path, nvcc/ptxas output; empty when nothing was compiled)."""
    return _compile(CSRC / f"{name}.cu", nvcc(), NVCC_FLAGS)


def compile_host_source(src: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Compile the host C++ source `src` with g++ (GXX_FLAGS) unless its
    library is up to date. Returns (library path, g++ output)."""
    return _compile(src, gxx(), GXX_FLAGS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)[0]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of csrc/<name>.cu, returning an int (the
    CUDA error of its launches), with its argument types bound: pointers
    and the stream as ctypes.c_void_p, so that ctypes does not cut them
    to 32 bits."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


_bound: dict = {}  # (name, symbol, which arguments are ints) → bound entry point
# the current stream's handle on a device index, without building a
# torch.cuda.Stream (the call torch's generated launchers make)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream_handle(device) -> int:
    """The cudaStream_t of the current stream of CUDA `device`."""
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(wrapper, name: str, symbol: str, args, device) -> None:
    """Run the C entry point `symbol` of csrc/<name>.cu on the current
    stream of `device`. It takes `args` (a tensor or a numpy array as its
    data pointer, None as a null pointer, an int as an int), then the
    stream and an int* through which it reports how many launches it made,
    and returns the first CUDA error. Adds those launches to `wrapper.launches`, then raises
    RuntimeError if the error is not 0. The entry point runs with `device`
    current (switched to and back only when another device is)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    ints = tuple(isinstance(a, (int, np.integer)) for a in args)
    fn = _bound.get((name, symbol, ints))
    if fn is None:
        fn = _bound[name, symbol, ints] = function(
            name, symbol, [i if n else vp for n in ints] + [vp, ctypes.POINTER(i)])
    ptrs = [int(a) if n else None if a is None else a.ctypes.data
            if isinstance(a, np.ndarray) else a.data_ptr() for a, n in zip(args, ints)]
    launched = ctypes.c_int(0)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*ptrs, current_stream_handle(device), ctypes.byref(launched))
    else:
        with torch.cuda.device(device):
            err = fn(*ptrs, current_stream_handle(device), ctypes.byref(launched))
    wrapper.launches += launched.value
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def check_tensor(name: str, t, shape, dtype, device) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` on `device`."""
    if (t.device != device or tuple(t.shape) != tuple(shape)
            or t.dtype != dtype or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
