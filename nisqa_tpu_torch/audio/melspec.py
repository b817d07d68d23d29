"""Host-side reflect padding of one signal into a fixed-size batch row.

The port's copy of ``pad_audio_for_batch`` from ``nisqa_tpu/audio/melspec.py``
(the only function of that module the port uses), so the port imports nothing
of the JAX package; tests hold the two equal.
"""

from __future__ import annotations

import numpy as np


def reflect_pad(y: np.ndarray, pad: int) -> np.ndarray:
    """np.pad(..., mode='reflect') equivalent used by librosa's centred STFT."""
    return np.pad(y, pad, mode="reflect")


def pad_audio_for_batch(y: np.ndarray, n_fft: int, buf_len: int) -> np.ndarray:
    """Reflect-pad a signal and place it in a fixed-size buffer.

    The reflect padding depends on the *true* signal, so it is done host-side
    (cheap memcpy); the device then only sees static shapes.
    ``buf_len`` must be >= len(y) + n_fft.
    """
    out = np.zeros(buf_len, dtype=np.float32)
    ypad = reflect_pad(np.asarray(y, dtype=np.float32), n_fft // 2)
    out[: len(ypad)] = ypad
    return out
