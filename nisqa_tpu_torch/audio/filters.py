"""Mel filterbank and analysis-window construction (host-side, precomputed).

Reproduces, from the published formulas, the constants the reference gets from
librosa (`nisqa/NISQA_lib.py:2311-2328`):
``melspectrogram(..., n_mels, fmin=0, fmax, htk=False, norm='slaney')`` with a
periodic Hann window of length ``int(sr * ms_win_length)`` zero-padded to
``n_fft`` and centred.

The Slaney mel scale is linear below 1 kHz (mel = hz / (200/3)) and
logarithmic above (step = ln(6.4)/27 per mel). Filters are triangles between
adjacent mel band edges with 'slaney' area normalisation 2/(f[i+2]-f[i]).
These are closed-form definitions, so the filterbank is exact.

The port's copy of ``nisqa_tpu/audio/filters.py`` (same functions, same names), so the
port imports nothing of the JAX package; tests hold the two equal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised mel filterbank, shape (n_mels, 1 + n_fft//2), float32."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float64)

    mel_edges = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_edges = mel_to_hz_slaney(mel_edges)  # (n_mels + 2,)

    fdiff = np.diff(hz_edges)
    ramps = hz_edges[:, None] - fftfreqs[None, :]  # (n_mels+2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney normalisation: equal area per filter
    enorm = 2.0 / (hz_edges[2 : n_mels + 2] - hz_edges[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=32)
def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, float64 precision then float32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@lru_cache(maxsize=32)
def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window zero-padded to n_fft and centred (librosa ``pad_center``)."""
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    w = hann_periodic(win_length)
    out = np.zeros(n_fft, dtype=np.float32)
    lpad = (n_fft - win_length) // 2
    out[lpad : lpad + win_length] = w
    return out
