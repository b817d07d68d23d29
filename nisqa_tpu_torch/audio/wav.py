"""RIFF/WAVE decoding without third-party audio libraries.

The reference front-end (`nisqa/NISQA_lib.py:2284-2331`) loads audio
with ``librosa.load`` (soundfile backend): samples are converted to float32 in
[-1, 1) by dividing by 2**(bits-1), multi-channel audio is averaged to mono
*after* float conversion (or a single channel is selected when ``ms_channel``
is given), and ``sr=None`` keeps the file's native sample rate.

This module reproduces that behaviour from first principles with a small numpy
RIFF parser supporting PCM 8/16/24/32-bit and IEEE float 32/64-bit, including
WAVE_FORMAT_EXTENSIBLE headers.

The port's copy of ``nisqa_tpu/audio/wav.py`` (same functions, same names), so the
port imports nothing of the JAX package; tests hold the two equal.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    n_channels: int
    n_frames: int
    bits_per_sample: int
    format_tag: int

    @property
    def duration(self) -> float:
        return self.n_frames / float(self.sample_rate)


class WavFormatError(ValueError):
    pass


def sniff_format(head: bytes) -> str:
    """Identify an audio container from its first bytes."""
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"OggS":
        return "ogg"
    if head[:3] == b"ID3" or (len(head) > 1 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    if head[4:8] == b"ftyp":
        return "m4a/mp4"
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    return "unknown"


def _unsupported(path: str, fmt: str) -> WavFormatError:
    """Actionable error for undecodable inputs, naming file and format —
    the analog of the reference's load-error wrapping
    (`nisqa/NISQA_lib.py:2298-2306`)."""
    what = f"detected format '{fmt}'" if fmt != "unknown" else "unrecognised format"
    return WavFormatError(
        f"Error loading file {path}: {what}. WAV (PCM/IEEE-float) and FLAC "
        "decode natively; mp3/ogg/m4a/opus need the system FFmpeg libraries "
        "(unavailable or failed here) — convert to wav or flac first."
    )


def _read_via_codec(path: str, kind: str, channel: int | None, mono: bool):
    """Decode a compressed file through the system-codec shim (the
    reference's audioread analog, `NISQA_lib.py:2298-2306`). Returns
    (samples, sr) or raises the actionable format error when the host has
    no codec libraries or the decode fails."""
    from . import codec

    if not codec.available():
        raise _unsupported(path, kind)
    try:
        x, sr = codec.decode(path)
    except codec.CodecError as e:
        err = _unsupported(path, kind)
        raise WavFormatError(f"{err} (codec: {e})") from e
    if x.ndim > 1:
        if channel is not None:
            x = x[channel]
        elif mono:
            x = x.mean(axis=0).astype(np.float32)
    return x, sr


def _parse_chunks(buf: bytes):
    """Yield (chunk_id, offset, size) for every top-level RIFF chunk."""
    if len(buf) < 12 or buf[0:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    pos = 12
    n = len(buf)
    while pos + 8 <= n:
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        data_off = pos + 8
        yield cid, data_off, min(size, n - data_off)
        pos = data_off + size + (size & 1)  # chunks are word-aligned


def _decode_samples(raw: bytes, fmt: int, bits: int, n_channels: int) -> np.ndarray:
    """Decode interleaved sample bytes to float32 in [-1, 1)."""
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise WavFormatError(f"unsupported float bit depth: {bits}")
    elif fmt == WAVE_FORMAT_PCM:
        if bits == 8:
            # 8-bit PCM is unsigned
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            # assemble little-endian 24-bit into int32 with sign extension
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise WavFormatError(f"unsupported PCM bit depth: {bits}")
    else:
        raise WavFormatError(f"unsupported WAVE format tag: {fmt:#x}")

    if n_channels > 1:
        n = len(x) // n_channels
        x = x[: n * n_channels].reshape(n, n_channels).T  # (C, N) like librosa
    return x


def read_wav(path: str, channel: int | None = None, mono: bool = True):
    """Read a WAV file -> (samples float32, sample_rate).

    ``channel``: select one channel (reference ``ms_channel``,
    `nisqa/NISQA_lib.py:2299-2303`). Otherwise channels are
    averaged to mono when ``mono`` is True (librosa default).
    Returns samples with shape (N,) when mono/channel-selected, else (C, N).
    """
    with open(path, "rb") as f:
        buf = f.read()

    kind = sniff_format(buf[:16])
    if kind == "flac":
        from .flac import read_flac

        return read_flac(path, channel=channel, mono=mono)
    if kind != "wav":
        return _read_via_codec(path, kind, channel, mono)

    fmt_tag = None
    bits = None
    n_channels = None
    sample_rate = None
    data = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            fmt_tag, n_channels, sample_rate = struct.unpack_from("<HHI", buf, off)
            (bits,) = struct.unpack_from("<H", buf, off + 14)
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # sub-format GUID: first two bytes carry the real format tag
                (fmt_tag,) = struct.unpack_from("<H", buf, off + 24)
        elif cid == b"data":
            data = buf[off : off + size]

    if fmt_tag is None or data is None:
        raise WavFormatError(f"missing fmt/data chunk in {path}")

    x = _decode_samples(data, fmt_tag, bits, n_channels)
    if n_channels > 1:
        if channel is not None:
            x = x[channel]
        elif mono:
            x = x.mean(axis=0).astype(np.float32)
    return x, sample_rate


def read_wav_pcm16_mono(path: str):
    """Fast path: return raw little-endian int16 samples for PCM16 mono files.

    Returns (np.int16 array, sample_rate) or None when the file is not
    plain 16-bit mono PCM (caller falls back to :func:`read_wav`).
    The int16 values divided by 32768 are exactly librosa's float samples,
    so downstream code can defer the scaling (e.g. onto the TPU).
    """
    with open(path, "rb") as f:
        buf = f.read()
    kind = sniff_format(buf[:16])
    if kind == "flac":
        from .flac import read_flac_pcm16_mono

        return read_flac_pcm16_mono(path)
    if kind != "wav":
        from . import codec

        if codec.available():
            return None  # caller falls back to read_wav -> codec decode
        raise _unsupported(path, kind)
    fmt_tag = bits = n_channels = None
    data = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            fmt_tag, n_channels, sample_rate = struct.unpack_from("<HHI", buf, off)
            (bits,) = struct.unpack_from("<H", buf, off + 14)
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                (fmt_tag,) = struct.unpack_from("<H", buf, off + 24)
        elif cid == b"data":
            data = buf[off : off + size]
    if fmt_tag != WAVE_FORMAT_PCM or bits != 16 or n_channels != 1 or data is None:
        return None
    return np.frombuffer(data, dtype="<i2"), sample_rate


def wav_info(path: str) -> WavInfo:
    """Read only the WAV header (no sample decode) — used for length bucketing."""
    with open(path, "rb") as f:
        buf = f.read(65536)
    fmt_tag = bits = n_channels = sample_rate = None
    data_size = 0
    try:
        for cid, off, size in _parse_chunks(buf):
            if cid == b"fmt ":
                fmt_tag, n_channels, sample_rate = struct.unpack_from("<HHI", buf, off)
                (bits,) = struct.unpack_from("<H", buf, off + 14)
                if fmt_tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    (fmt_tag,) = struct.unpack_from("<H", buf, off + 24)
            elif cid == b"data":
                # size field is authoritative even if we did not read the body
                (data_size,) = struct.unpack_from("<I", buf, off - 4)
    except WavFormatError:
        raise
    if fmt_tag is None:
        raise WavFormatError(f"missing fmt chunk in {path}")
    bytes_per_frame = n_channels * (bits // 8)
    return WavInfo(sample_rate, n_channels, data_size // bytes_per_frame, bits, fmt_tag)


def write_wav(path: str, x: np.ndarray, sample_rate: int):
    """Write float32 [-1,1] samples as 16-bit PCM (test/bench fixture helper)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    n_channels, n = x.shape
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    pcm = pcm.T.reshape(-1).tobytes()
    with open(path, "wb") as f:
        byte_rate = sample_rate * n_channels * 2
        hdr = io.BytesIO()
        hdr.write(b"RIFF")
        hdr.write(struct.pack("<I", 36 + len(pcm)))
        hdr.write(b"WAVE")
        hdr.write(b"fmt ")
        hdr.write(struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate, byte_rate, n_channels * 2, 16))
        hdr.write(b"data")
        hdr.write(struct.pack("<I", len(pcm)))
        f.write(hdr.getvalue())
        f.write(pcm)


def resample_poly(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy) — kept as an alternative backend.

    See :func:`resample_kaiser` for the default ``ms_sr`` path.
    """
    if sr_in == sr_out:
        return x
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(int(sr_in), int(sr_out))
    return _rp(x, int(sr_out) // g, int(sr_in) // g).astype(np.float32)


_KAISER_BEST = None


def _kaiser_best_window():
    """resampy's 'kaiser_best' interpolation filter, built from its published
    parameters: 64 zero crossings, 512 table entries per crossing, rolloff
    0.9475937167399596, Kaiser beta 14.769656459379492."""
    global _KAISER_BEST
    if _KAISER_BEST is None:
        num_zeros, precision = 64, 9
        rolloff, beta = 0.9475937167399596, 14.769656459379492
        num_bits = 1 << precision
        n = num_bits * num_zeros
        taps = np.arange(n + 1, dtype=np.float64) / num_bits
        win = rolloff * np.sinc(rolloff * taps) * np.kaiser(2 * n + 1, beta)[n:]
        delta = np.diff(np.concatenate([win, [0.0]]))
        _KAISER_BEST = (win, delta, num_bits)
    return _KAISER_BEST


def resample_kaiser(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Windowed-sinc resampling matching resampy's ``kaiser_best`` algorithm.

    The reference resamples via ``librosa.load(sr=ms_sr)`` -> resampy
    kaiser_best (`nisqa/NISQA_lib.py:2299-2304`). This is the
    same computation — per output sample, both filter wings are evaluated
    from the tabulated sinc-Kaiser window with linear interpolation between
    table entries — vectorised over output samples with a loop over taps.
    (resampy itself is not installed here; equivalence is by construction
    from its published algorithm and parameters, and the spectral agreement
    with scipy polyphase is pinned in tests/test_audio_resample.py.)
    """
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float64)
    win, delta, num_bits = _kaiser_best_window()
    n_win = len(win)
    scale = min(1.0, sr_out / sr_in)
    index_step = int(scale * num_bits)
    n_out = int(np.ceil(len(x) * sr_out / sr_in))

    t = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    n = t.astype(np.int64)
    frac = scale * (t - n)
    out = np.zeros(n_out, np.float64)

    def wing(frac_w, sample_of_i):
        idx_frac = frac_w * num_bits
        offset = idx_frac.astype(np.int64)
        eta = idx_frac - offset
        # run the tap loop long enough for the smallest offset (longest
        # wing); the per-sample `valid` mask trims the shorter ones
        i_max = (n_win - offset.min() - 1) // index_step + 1
        for i in range(int(i_max)):
            w_idx = offset + i * index_step
            valid = w_idx < n_win
            w_idx = np.minimum(w_idx, n_win - 1)
            w = win[w_idx] + eta * delta[w_idx]
            s = sample_of_i(i)
            s_valid = valid & (s >= 0) & (s < len(x))
            out[s_valid] += w[s_valid] * x[np.clip(s, 0, len(x) - 1)][s_valid]

    wing(frac, lambda i: n - i)               # left wing: x[n-i]
    wing(scale - frac, lambda i: n + i + 1)   # right wing: x[n+i+1]
    if scale < 1.0:
        out *= scale
    return out.astype(np.float32)
