"""Batched front-end: audio buffer -> mel dB -> segments, on one device.

Counterpart of ``nisqa_tpu/data/pipeline.py::_front_end`` (``mel_fn`` and
``seg_fn``). The geometry and the host-computed constants are the JAX
package's own (:func:`front_end_consts`), so the same buffers give the
same mels:

  * frame ``t`` is ``audio[b, t*hop + lpad : t*hop + lpad + win]`` with
    ``lpad = (n_fft - win) // 2``: the analysis window is nonzero on only
    ``win`` of the zero-padded ``n_fft`` samples, and the window, the PCM16
    scale and the DFT terms are folded into ``w_re`` / ``w_im``;
  * the DFT -> |.| -> mel step is one call of ``dft_mel`` (the fused CUDA
    kernel on the card);
  * 20*log10 with a per-file floor 80 dB under the peak of the VALID frames;
  * segments of ``seg_length`` frames at ``seg_hop``, zeroed past ``n_wins``
    (ceil when ``seg_hop > 1``, a recorded deliberate deviation that both
    packages share, docs/PARITY_MAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.filters import mel_filterbank, padded_window
from ..ops.dft_mel import fused_dft_mel


def front_end_consts(ms, sr: int, transport: str = "f32"):
    """Host-computed windowed-DFT + mel tensors (numpy float32).

    The window, the librosa 1/32768 PCM16 scaling (transport='i16') and the
    zero-padding of the n_fft frame are folded into the DFT weights; only
    the DFT bins the mel filterbank reads are kept (rounded up to a multiple
    of 128, as in the JAX package, so both compute over the same bins).
    """
    win = int(sr * ms.win_s)
    n_fft = ms.n_fft

    fb = mel_filterbank(int(sr), n_fft, ms.n_mels, 0.0, ms.fmax)  # (M, K)
    nz = np.nonzero(fb.any(axis=0))[0]
    k_hi = int(nz[-1]) + 1 if len(nz) else fb.shape[1]
    k_keep = min(-(-k_hi // 128) * 128, fb.shape[1])

    lpad = (n_fft - win) // 2
    window = padded_window(win, n_fft).astype(np.float64)
    scale = (1.0 / 32768.0) if transport == "i16" else 1.0
    s_idx = lpad + np.arange(win)
    wvals = window[s_idx] * scale
    ang = -2.0 * np.pi * np.outer(s_idx, np.arange(k_keep)) / n_fft
    return {
        "w_re": (wvals[:, None] * np.cos(ang)).astype(np.float32),
        "w_im": (wvals[:, None] * np.sin(ang)).astype(np.float32),
        "fb_t": np.ascontiguousarray(fb[:, :k_keep].T),
    }


def frame_geometry(ms, sr: int, t_bucket: int):
    """(hop, win, lpad, n_frames_max, buf_len) of a (sample rate, T bucket).

    ``buf_len`` is the reflect-padded audio buffer length the host fills,
    equal to the JAX package's (``pipeline.py:132-141``).
    """
    hop = int(sr * ms.hop_s)
    win = int(sr * ms.win_s)
    n_frames_max = ms.frames_for_bucket(t_bucket)
    lpad = (ms.n_fft - win) // 2
    r1 = (lpad + win - 1) // hop
    return hop, win, lpad, n_frames_max, (n_frames_max + r1) * hop


def mel_fn(ms, sr: int, t_bucket: int, consts: dict, audio, n_samples,
           fast: bool = False, dft_mel=fused_dft_mel):
    """(audio (B, buf_len) int16 or float32, n_samples (B,)) -> mel dB
    (B, n_frames_max, n_mels) float32, top_db-clipped per file."""
    hop, win, lpad, n_frames, _ = frame_geometry(ms, sr, t_bucket)
    b = audio.shape[0]
    # zero-copy hop-strided view, then one copy into contiguous rows: float32,
    # or bf16 in fast mode (the DFT's operand rounding, done once here; i16 and
    # float32 samples round to the same bf16 values as through float32)
    frames = audio[:, lpad:].unfold(-1, win, hop)[:, :n_frames]
    frames = frames.to(torch.bfloat16 if fast else torch.float32)
    frames = frames.contiguous().view(b * n_frames, win)
    mel = dft_mel(frames, consts["w_re"], consts["w_im"], consts["fb_t"], bf16=fast)
    db = 20.0 * torch.log10(torch.clamp(mel.view(b, n_frames, -1), min=1e-4))
    valid = torch.arange(n_frames, device=audio.device)[None, :] < (1 + n_samples // hop)[:, None]
    mx = torch.where(valid[:, :, None], db, -torch.inf).amax(dim=(1, 2), keepdim=True)
    return torch.maximum(db, mx - 80.0)


def seg_fn(ms, sr: int, t_bucket: int, db, n_samples):
    """mel dB (B, n_frames_max, M) -> (segs (B, T, M, S), n_wins (B,))."""
    hop = int(sr * ms.hop_s)
    s, seg_hop = ms.seg_length, ms.seg_hop
    # (B, T, M, S) windows: frames t*seg_hop .. t*seg_hop + S - 1
    segs = db.unfold(1, s, seg_hop)[:, :t_bucket]
    full = 1 + n_samples // hop - (s - 1)
    n_wins = -torch.div(-full, seg_hop, rounding_mode="floor") if seg_hop > 1 else full
    t_mask = torch.arange(t_bucket, device=db.device)[None, :] < n_wins[:, None]
    return torch.where(t_mask[:, :, None, None], segs, 0.0), n_wins
