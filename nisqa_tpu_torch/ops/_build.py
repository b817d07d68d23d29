"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources under ``nisqa_tpu_torch/csrc/`` expose plain C entry points, so
they compile with nvcc alone in seconds (no PyTorch headers). The library
is built at first use into ``nisqa_tpu_torch/_build/``; its file name
carries a hash of the sources and flags, so an edit rebuilds it. Nothing is
built at import time: this module is imported on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("dft_mel.cu", "bn_relu_pool.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libnisqa_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists.

    Returns the library path. The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept beside it as ``.log``.
    """
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{r.stdout}\n{r.stderr}")
    with open(path[: -len(".so")] + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, path)
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib = ctypes.CDLL(build())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.nisqa_dft_mel.argtypes = [
        ptr, i64, ptr, ptr, i32,            # frames, frames_ld, w, w_lo, w_ld
        ptr, ptr, i32,                      # chunk_tiles, chunk_start, chunks
        i32, i32,                           # tiles_per_split, splits
        ptr, ptr, ptr,                      # fb, out, scratch
        i64, i32, i32, i32, i32, ptr,       # n, span, k_pad, m, exact, stream
    ]
    lib.nisqa_dft_mel.restype = ctypes.c_int
    lib.nisqa_bn_relu_pool.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x, out, conv_bias, mean, var, weight, bias
        ctypes.c_float, i64, i32,           # eps, planes, channels
        i32, i32, i32, i32, i32, ptr,       # h, w, oh, ow, tile_planes, stream
    ]
    lib.nisqa_bn_relu_pool.restype = ctypes.c_int
    lib.nisqa_bias_bn_relu.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x, out, conv_bias, mean, var, weight, bias
        ctypes.c_float, i64, i32, i32, ptr,  # eps, numel, channels, plane, stream
    ]
    lib.nisqa_bias_bn_relu.restype = ctypes.c_int
    lib.nisqa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nisqa_cuda_error_string.restype = ctypes.c_char_p
    return lib
