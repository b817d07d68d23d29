"""Seeded pairs of degraded and reference PCM16 WAV files, made on the
device in bulk, for the double-ended (full-reference) model.

Every seed gets the same set of degraded lengths and of delays, in another
order: the lengths are the ``n`` evenly spaced quantiles of the mix's length
distribution (``corpus.lengths``), the delays the quantiles of a uniform
range, each permuted by its own stream of the seed. The seed draws the
content:

  * the source is the benchmark's tone recipe made non-stationary: f0
    uniform in [f0_lo, f0_hi] Hz, drawn anew for each stretch of a length
    uniform in [stretch_lo, stretch_hi] s, at amplitude 0.3, with its
    partial at 3.1 f0 at 0.1; the phase runs on across the jumps;
  * the reference end is the source, of the degraded length less the delay;
  * the degraded end is the source delayed by the delay (zeros first), with
    ``zero_share`` of its ``frame_s`` frames zeroed at seeded places (lost
    packets), then white noise at an SNR uniform in [snr_lo, snr_hi] dB over
    the source's mean power (``tools.corpus.de_corpus``'s rule);

both rounded to PCM16.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import corpus


def delays(n: int, lo_s: float, hi_s: float, sr: int, seed: int) -> np.ndarray:
    """Sample counts of ``n`` delays: the quantiles of uniform [lo_s, hi_s]
    at (i + 0.5) / n, permuted by ``seed``."""
    q = (np.arange(n) + 0.5) / n
    return np.random.default_rng(seed).permutation(((lo_s + q * (hi_s - lo_s)) * sr).astype(np.int64))


def _uniform(g, lo, hi, device, size=()) -> torch.Tensor:
    return torch.rand(size, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo


def _source(n: int, sr: int, mix: dict, g, device) -> torch.Tensor:
    """float64 (n,) samples of the non-stationary tone."""
    lo = float(mix["stretch_s_lo"])
    k = int(np.ceil(n / (lo * sr))) + 1
    length = torch.round(_uniform(g, lo, float(mix["stretch_s_hi"]), device, k) * sr).to(torch.int64)
    f0 = _uniform(g, float(mix["f0_lo"]), float(mix["f0_hi"]), device, k)
    freq = torch.repeat_interleave(f0, length)[:n]
    phase = 2 * np.pi * (torch.cumsum(freq, 0) - freq[0]) / sr
    return 0.3 * torch.sin(phase) + 0.1 * torch.sin(3.1 * phase)


def _pcm16(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y * 32767.0), -32768, 32767).to(torch.int16)


def synth(n_deg: np.ndarray, delay: np.ndarray, sr: int, mix: dict, seed: int, device):
    """(degraded, reference) PCM16 samples of each pair (host int16 arrays)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    frame = int(round(float(mix["frame_s"]) * sr))
    deg, ref = [], []
    for n, d in zip(n_deg.tolist(), delay.tolist()):
        src = _source(n - d, sr, mix, g, device)
        y = torch.cat([torch.zeros(d, device=device, dtype=torch.float64), src])
        frames = n // frame
        n_lost = int(round(float(mix["zero_share"]) * frames))
        lost = torch.randperm(frames, generator=g, device=device)[:n_lost]
        y[: frames * frame].view(frames, frame)[lost] = 0.0
        snr_db = float(_uniform(g, float(mix["snr_db_lo"]), float(mix["snr_db_hi"]), device))
        noise = torch.randn(n, generator=g, device=device, dtype=torch.float64)
        noise *= torch.sqrt(src.square().mean() / (10 ** (snr_db / 10)) / noise.square().mean())
        deg.append(_pcm16(y + noise))
        ref.append(_pcm16(src))
    flat_d, flat_r = torch.cat(deg).cpu().numpy(), torch.cat(ref).cpu().numpy()
    od = np.concatenate([[0], np.cumsum(n_deg)])
    orf = np.concatenate([[0], np.cumsum(n_deg - delay)])
    return ([flat_d[od[i]:od[i + 1]] for i in range(len(n_deg))],
            [flat_r[orf[i]:orf[i + 1]] for i in range(len(n_deg))])


def make(out_dir: str, mix: dict, seed: int, device):
    """Writes ``mix["pairs"]`` pairs; returns (degraded paths, reference
    paths, degraded PCM16 arrays, reference PCM16 arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    n, sr = int(mix["pairs"]), int(mix["sr"])
    n_deg = corpus.lengths(n, mix["seconds_lo"], mix["seconds_hi"], mix["dist"], sr,
                           corpus.seed_stream(seed, 1))
    delay = delays(n, float(mix["delay_s_lo"]), float(mix["delay_s_hi"]), sr,
                   corpus.seed_stream(seed, 4))
    pcm_d, pcm_r = synth(n_deg, delay, sr, mix, corpus.seed_stream(seed, 2), device)
    deg = [os.path.join(out_dir, f"deg_{i:05d}.wav") for i in range(n)]
    ref = [os.path.join(out_dir, f"ref_{i:05d}.wav") for i in range(n)]
    for paths, pcm in ((deg, pcm_d), (ref, pcm_r)):
        for p, x in zip(paths, pcm):
            corpus.write_wav(p, x, sr)
    return deg, ref, pcm_d, pcm_r
