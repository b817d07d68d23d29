"""Seeded corpora of PCM16 WAV files, made on the device in bulk.

Every seed gets the same set of file lengths, in another order: the lengths
are the ``n`` evenly spaced quantiles of the mix's length distribution
(log-uniform or uniform between ``seconds_lo`` and ``seconds_hi``), and the
seed permutes them and draws each file's pitch and noise. A file is the
recipe of the repository's serving benchmark: a tone at f0 (uniform in
100-300 Hz) at amplitude 0.3, its partial at 3.1 f0 at 0.1, and white noise
at 0.05, rounded to PCM16.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch


def seed_stream(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use (``stream``) of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (2 ** 63), stream]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def lengths(n: int, lo: float, hi: float, dist: str, sr: int, seed: int) -> np.ndarray:
    """Sample counts of ``n`` files: the distribution's quantiles at
    (i + 0.5) / n, permuted by ``seed``."""
    q = (np.arange(n) + 0.5) / n
    if dist == "log_uniform":
        sec = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    elif dist == "uniform":
        sec = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.random.default_rng(seed).permutation((sec * sr).astype(np.int64))


def synth(n_samples: np.ndarray, sr: int, seed: int, device) -> list:
    """PCM16 samples of each file (host int16 arrays), made on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f0 = torch.rand(len(n_samples), generator=g, device=device, dtype=torch.float64) * 200 + 100
    noise = torch.randn(int(n_samples.sum()), generator=g, device=device)
    pcm, start = [], 0
    for i, n in enumerate(n_samples.tolist()):
        t = torch.arange(n, device=device, dtype=torch.float64) / sr
        y = (0.3 * torch.sin(2 * np.pi * f0[i] * t) + 0.1 * torch.sin(2 * np.pi * 3.1 * f0[i] * t)
             + 0.05 * noise[start:start + n])
        start += n
        pcm.append(torch.clamp(torch.round(y * 32767.0), -32768, 32767).to(torch.int16))
    flat = torch.cat(pcm).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(n_samples)])
    return [flat[offsets[i]:offsets[i + 1]] for i in range(len(n_samples))]


def write_wav(path: str, pcm: np.ndarray, sr: int):
    """A 16-bit mono PCM WAV file."""
    data = pcm.astype("<i2", copy=False).tobytes()
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16)
              + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)


def make(out_dir: str, n: int, lo: float, hi: float, dist: str, sr: int, seed: int, device):
    """Writes the corpus; returns (paths, PCM16 arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    pcm = synth(lengths(n, lo, hi, dist, sr, seed_stream(seed, 1)), sr, seed_stream(seed, 2), device)
    paths = [os.path.join(out_dir, f"f{i:05d}.wav") for i in range(n)]
    for p, x in zip(paths, pcm):
        write_wav(p, x, sr)
    return paths, pcm
