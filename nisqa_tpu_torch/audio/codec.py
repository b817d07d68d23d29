"""System-codec audio decode (mp3/ogg/m4a/…) via the native FFmpeg shim.

The reference accepts compressed formats exactly as far as the host's system
codecs do: ``librosa.load`` falls back to audioread, which shells into
GStreamer/FFmpeg (`nisqa/NISQA_lib.py:2298-2306`). ``native/codecdecode.cpp``
binds the host's libavformat/libavcodec. When the FFmpeg libraries (or the
toolchain) are absent, :func:`available` is False and the WAV front door
keeps raising its actionable format error — identical to the reference on a
codec-less host.

Decoded samples keep the file's native sample rate and channel count;
mono mix-down / channel selection happens in numpy in ``audio/wav.py`` so the
semantics are bit-identical to the WAV path (float-mean of channels).

The port's copy of ``nisqa_tpu/audio/codec.py`` (same functions, same names),
so the port imports nothing of the JAX package. The shim is compiled with
``g++`` at first use into ``nisqa_tpu_torch/_build/`` under a source-hash
name (``data/native.py::build_host_library``); ``native/`` is only read.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..data.native import build_host_library

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("NISQA_TPU_NO_NATIVE") or os.environ.get("NISQA_TPU_NO_CODEC"):
        return None
    try:
        lib = ctypes.CDLL(build_host_library(
            "codecdecode.cpp", "libcodecdecode", extra=("-I/usr/include/x86_64-linux-gnu",),
            libs=("-lavformat", "-lavcodec", "-lavutil")))
    except (OSError, RuntimeError):
        return None
    lib.codec_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_decode.restype = ctypes.c_int
    lib.codec_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.codec_free.restype = None
    lib.codec_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_encode.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """True when the host's FFmpeg libraries are bound and ready."""
    return _load() is not None


class CodecError(ValueError):
    pass


def decode(path: str):
    """Decode any system-codec-supported file -> (samples, sample_rate).

    ``samples`` is float32 with shape (N,) for mono files and (C, N)
    otherwise — the same layout ``audio/wav.py::read_wav`` produces before
    its mono/channel handling.
    """
    lib = _load()
    if lib is None:
        raise CodecError("system codec libraries unavailable")
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    rc = lib.codec_decode(path.encode(), ctypes.byref(buf), ctypes.byref(n),
                          ctypes.byref(sr), ctypes.byref(ch), err, len(err))
    if rc != 0:
        raise CodecError(err.value.decode(errors="replace") or f"decode failed (rc={rc})")
    try:
        flat = np.ctypeslib.as_array(buf, shape=(n.value * ch.value,))
        x = np.array(flat, dtype=np.float32)  # copy out of the C buffer
    finally:
        lib.codec_free(buf)
    if ch.value > 1:
        x = np.ascontiguousarray(x.reshape(n.value, ch.value).T)
    return x, int(sr.value)


def encode(path: str, x: np.ndarray, sample_rate: int, bitrate: int = 128000):
    """Encode float32 samples to ``path`` (format by extension) — test-vector
    generation only; the serving path never encodes. ``x``: (N,) mono or
    (C, N) multi-channel in [-1, 1]."""
    lib = _load()
    if lib is None:
        raise CodecError("system codec libraries unavailable")
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        inter, n_ch = x, 1
    else:
        n_ch = x.shape[0]
        inter = np.ascontiguousarray(x.T).reshape(-1)
    inter = np.ascontiguousarray(inter)
    err = ctypes.create_string_buffer(512)
    rc = lib.codec_encode(
        path.encode(), inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(inter) // n_ch), n_ch, int(sample_rate),
        int(bitrate), err, len(err))
    if rc != 0:
        raise CodecError(err.value.decode(errors="replace") or f"encode failed (rc={rc})")
