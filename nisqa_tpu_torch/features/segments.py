"""Mel-spectrogram segment windowing: the host reference.

Reproduces NISQA's `segment_specs` (`nisqa/NISQA_lib.py:2239-2282`):
a width-``seg_length`` (odd) window slides over the mel frames; the number of
full windows is ``n_wins_full = W - (seg_length - 1)``; windows are then
subsampled by ``seg_hop`` giving ``n_wins = ceil(n_wins_full / seg_hop)`` and
zero-padded to ``max_length``.

The device path segments a whole batch at once (``data/front_end.py::
seg_fn``); :func:`segment_np` is the per-file oracle it is held against.
Layout: (max_length, n_mels, seg_length) per file, the model's (B, T, M, S)
without the batch axis.

The port's copy of ``nisqa_tpu/features/segments.py`` (same functions, same
names), so the port imports nothing of the JAX package; tests hold the two
equal.
"""

from __future__ import annotations

import numpy as np


def n_wins_for(n_frames: int, seg_length: int, seg_hop: int) -> int:
    """Valid window count for a spectrogram with ``n_frames`` frames."""
    full = n_frames - (seg_length - 1)
    if full < 1:
        raise ValueError(
            f"Sample too short: only {n_frames} frames for seg_length={seg_length}"
        )
    return int(np.ceil(full / seg_hop)) if seg_hop > 1 else int(full)


def segment_np(spec: np.ndarray, seg_length: int, seg_hop: int, max_length: int):
    """Host reference segmentation. spec: (n_mels, W) -> (max_length, n_mels, seg_length)."""
    if seg_length % 2 == 0:
        raise ValueError(f"seg_length must be odd! (seg_length={seg_length})")
    n_mels, W = spec.shape
    n_wins = n_wins_for(W, seg_length, seg_hop)
    if max_length < n_wins:
        raise ValueError(f"n_wins {n_wins} > max_length {max_length}")
    out = np.zeros((max_length, n_mels, seg_length), dtype=np.float32)
    for t in range(n_wins):
        s = t * seg_hop
        out[t] = spec[:, s : s + seg_length]
    return out, n_wins
