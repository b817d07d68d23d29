"""ctypes bindings for the native C++ batch WAV/FLAC loader (``native/wavloader.cpp``).

The port's copy of ``nisqa_tpu/data/native.py``: the same functions with the
same names, so the port imports nothing of the JAX package. It differs in how
the library is made: the port compiles ``native/wavloader.cpp`` with ``g++``
itself, at first use, into the git-ignored ``nisqa_tpu_torch/_build/`` under a
name that carries a hash of the source and flags (as ``ops/_build.py`` does
for the CUDA kernel). It never runs ``make`` in ``native/`` and never loads
a library from there.

Host decode is not the device path: where ``g++`` or the library is missing
(or ``NISQA_TPU_NO_NATIVE`` is set), :func:`available` is False and the engine
decodes in Python, as the JAX loader does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "nisqa_tpu_torch", "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_tried = False


def build_host_library(source: str, stem: str, extra=(), libs=()) -> str:
    """Compile ``native/<source>`` with g++ into ``_build/<stem>_<hash>.so``
    unless that file exists; returns its path. Raises when g++ is missing or
    the compile fails. The file is written under a temporary name and
    renamed, so processes that build at once do not see a partial library."""
    src = os.path.join(NATIVE_DIR, source)
    flags = (*CXX_FLAGS, *extra)
    h = hashlib.sha256(" ".join(flags + tuple(libs)).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native host decoder cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *flags, src, "-o", tmp, "-lpthread", *libs],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {source} (exit {r.returncode}):\n{r.stderr[-2000:]}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("NISQA_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(build_host_library("wavloader.cpp", "libwavloader"))
    except (OSError, RuntimeError):
        return None
    lib.fill_batch_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.fill_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.scan_audio.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    for fn in (lib.fill_batch_i16, lib.fill_batch_f32, lib.scan_audio):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_rows(buf: np.ndarray, dtype, n_paths: int):
    if buf.dtype != dtype or buf.ndim != 2 or not buf.flags.c_contiguous:
        raise ValueError(f"need a C-contiguous 2-D {np.dtype(dtype)} buffer, got "
                         f"{buf.dtype} {buf.shape}")
    if buf.shape[0] < n_paths:
        raise ValueError(f"buffer has {buf.shape[0]} rows for {n_paths} files")


def fill_batch_i16(paths, buf: np.ndarray, pad: int, n_threads: int = 4):
    """Fill rows of ``buf`` (B, buf_len) int16 with reflect-padded PCM16.

    Returns (n_samples (B,) int32, sample_rates (B,) int32, status (B,)
    int32) — status != 0 means the row was not filled (caller falls back).
    Rows beyond len(paths) are untouched. The call releases the GIL (ctypes).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host decoder is not available")
    _check_rows(buf, np.int16, len(paths))
    n = len(paths)
    n_out, sr_out, status = (np.zeros(n, np.int32) for _ in range(3))
    lib.fill_batch_i16(
        _paths_array(paths), n,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(buf.shape[1]), ctypes.c_int64(pad),
        _i32(n_out), _i32(sr_out), _i32(status), n_threads,
    )
    return n_out, sr_out, status


def fill_batch_f32(paths, buf: np.ndarray, pad: int, channel=None, n_threads: int = 4):
    """Fill rows of ``buf`` (B, buf_len) float32 with reflect-padded samples
    from any natively-decodable WAV (8/16/24/32-bit PCM, IEEE float 32/64,
    multi-channel) or 16-bit mono FLAC. ``channel=None`` takes the float32
    channel mean (librosa mono semantics); an int selects that channel with
    numpy indexing (negative counts from the end, mono ignores it) —
    matching ``audio/wav.py::read_wav`` bit-for-bit.

    Returns (n_samples, sample_rates, status) int32 arrays; status != 0 rows
    were not filled (caller decodes those in Python).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host decoder is not available")
    _check_rows(buf, np.float32, len(paths))
    n = len(paths)
    n_out, sr_out, status = (np.zeros(n, np.int32) for _ in range(3))
    lib.fill_batch_f32(
        _paths_array(paths), n,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(buf.shape[1]), ctypes.c_int64(pad),
        # mean-sentinel is INT32_MIN, NOT -1: negative channel indices are
        # reference-legal (numpy x[channel] counts from the end)
        ctypes.c_int(-(2**31) if channel is None else int(channel)),
        _i32(n_out), _i32(sr_out), _i32(status), n_threads,
    )
    return n_out, sr_out, status


def scan_audio(paths, n_threads: int = 4):
    """Header-only scan -> (n_samples, sample_rates, kind, status) int32.

    kind 0 = raw-int16 transport eligible (PCM16-mono WAV / 16-bit mono
    FLAC), 1 = natively float32-decodable WAV, -1 = Python fallback.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host decoder is not available")
    n = len(paths)
    n_out, sr_out, kind, status = (np.zeros(n, np.int32) for _ in range(4))
    lib.scan_audio(_paths_array(paths), n, _i32(n_out), _i32(sr_out), _i32(kind),
                   _i32(status), n_threads)
    return n_out, sr_out, kind, status
