"""The seeded corpora the tools run over, and ``.tar`` files of the goldens' weights.

The recipes are those of the JAX package's tools, written through the
port's own ``write_wav``, so that the same seed gives the same bytes:

  * :func:`bench_corpus`: ``bench.py::make_corpus``, 48 kHz files of
    3-30 s (log-uniform) of a two-tone signal with noise, seed 0 (also at
    another rate: the same recipe sampled at ``sr``);
  * :func:`tts_corpus`: ``tools/bench_tts.py::make_corpus``, 48 kHz files
    of 10-40 s of an amplitude-modulated tone with noise, seed 3;
  * :func:`de_corpus`: ``tools/bench_de.py::make_de_corpus``, 8 s pairs at
    48 kHz: the reference a clean three-tone signal, the degraded end the
    reference plus white noise at an SNR uniform in [0, 40] dB, and
    MOS = 1 + 4 * SNR / 40; with ``portable`` the same bytes on every
    machine;
  * :func:`learnable_mos`: ``tools/bench_train.py::_learnable_mos``.

Two things differ from the originals. A file is written under a temporary
name and renamed into place, so a run that is cut leaves no half-written
WAV for the next run to reuse; and every draw of the random stream is made
whether or not the file already exists, so a corpus completed over several
runs holds the bytes that one run writes. Audio seconds are counted from
the sample counts.

:func:`golden_tar` writes a reference-format ``.tar`` from a golden's
released weights (``sd::*``) and architecture (``meta``) at a front-end
geometry, or from a seeded perturbation of those weights.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

import numpy as np
import torch

from ..audio.wav import read_wav, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDENS = os.path.join(REPO, "tests", "goldens")
# the released NISQA models' front-end (nisqa_tpu/config/train_nisqa_cnn_sa_ap.yaml)
YAML_GEOMETRY = {
    "ms_sr": None, "ms_fmax": 20000, "ms_n_fft": 4096, "ms_hop_length": 0.01,
    "ms_win_length": 0.02, "ms_n_mels": 48, "ms_seg_length": 15,
    "ms_seg_hop_length": 4, "ms_max_segments": 1300, "ms_channel": None,
}
# the released NISQA-TTS checkpoint's front-end
TTS_GEOMETRY = {**YAML_GEOMETRY, "ms_fmax": 8000, "ms_seg_hop_length": 1, "ms_max_segments": 6000}
# the yaml geometry at 80 mel bands: more than the DFT->mel kernel's 64-band tile
MEL80_GEOMETRY = {**YAML_GEOMETRY, "ms_n_mels": 80}
SR = 48000
DE_SECONDS = 8.0


def default_dir(name: str) -> str:
    """Where a tool keeps a corpus between runs: under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), f"nisqa_tpu_torch_{name}")


def _write(path: str, y, sr: int):
    """``write_wav`` to a temporary name in the same directory, then rename."""
    tmp = f"{path}.{os.getpid()}.part"
    write_wav(tmp, y, sr)
    os.replace(tmp, path)


def bench_corpus(out_dir: str, n_files: int = 384, seed: int = 0, sr: int = SR):
    """``bench.py``'s corpus, sampled at ``sr`` (``bench.py``'s: 48 kHz).
    Returns (audio seconds, paths)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    total, paths = 0.0, []
    for i in range(n_files):
        p = os.path.join(out_dir, f"bench_{i:03d}.wav")
        dur = float(np.exp(rng.uniform(np.log(3.0), np.log(30.0))))
        n = int(sr * dur)
        f0 = rng.uniform(100, 300)
        noise = rng.standard_normal(n)
        if not os.path.exists(p):
            t = np.arange(n) / sr
            y = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
                 + 0.05 * noise)
            _write(p, y.astype(np.float32), sr)
        paths.append(p)
        total += n / sr
    return total, paths


def tts_corpus(out_dir: str, n_files: int = 16, seed: int = 3):
    """``tools/bench_tts.py``'s corpus. Returns (audio seconds, paths)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    total, paths = 0.0, []
    for i in range(n_files):
        p = os.path.join(out_dir, f"tts_{i:02d}.wav")
        dur = float(np.exp(rng.uniform(np.log(10.0), np.log(40.0))))
        n = int(SR * dur)
        f0 = rng.uniform(90, 250)
        noise = rng.standard_normal(n)
        if not os.path.exists(p):
            t = np.arange(n) / SR
            y = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))
                 + 0.05 * noise)
            _write(p, y.astype(np.float32), SR)
        paths.append(p)
        total += n / SR
    return total, paths


def de_corpus(out_dir: str, n_pairs: int = 96, seed: int = 0, portable: bool = False):
    """``tools/bench_de.py``'s pair corpus. Returns (degraded audio seconds,
    degraded paths, reference paths, MOS).

    The noise's scale comes from the mean powers of the two signals, which
    the original takes as numpy's float32 means: their last bit depends on
    the CPU's vector width, and then so do most samples of the degraded
    file. ``portable`` takes them exactly rounded (``math.fsum``) instead,
    so that every machine writes the same bytes (a stored reference's
    corpus)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n = int(SR * DE_SECONDS)
    t = np.arange(n) / SR
    deg_paths, ref_paths, mos = [], [], []
    for i in range(n_pairs):
        f0 = rng.uniform(100, 300)
        ref = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 2.05 * f0 * t)
               + 0.05 * np.sin(2 * np.pi * 3.1 * f0 * t)).astype(np.float32)
        snr_db = rng.uniform(0.0, 40.0)
        noise = rng.standard_normal(n).astype(np.float32)
        if portable:
            power = [math.fsum(np.square(x, dtype=np.float64)) / n for x in (ref, noise)]
            noise *= math.sqrt(power[0] / (10 ** (snr_db / 10)) / power[1])
        else:
            noise *= np.sqrt((ref ** 2).mean() / (10 ** (snr_db / 10)) / (noise ** 2).mean())
        deg = np.clip(ref + noise, -0.999, 0.999)
        rp = os.path.join(out_dir, f"ref_{i:03d}.wav")
        dp = os.path.join(out_dir, f"deg_{i:03d}.wav")
        for p, y in ((rp, ref), (dp, deg)):
            if not os.path.exists(p):
                _write(p, y, SR)
        ref_paths.append(rp)
        deg_paths.append(dp)
        mos.append(round(float(1.0 + 4.0 * snr_db / 40.0), 2))
    return n_pairs * n / SR, deg_paths, ref_paths, np.array(mos)


def learnable_mos(paths):
    """MOS from each file's dominant pitch (the recipes' f0 is 100-300 Hz),
    mapped to [1, 5]: a spectral property the CNN can learn, estimated from
    the audio rather than replayed from the generator."""
    mos = []
    for p in paths:
        y, sr = read_wav(p)
        seg = y[: int(0.5 * sr)].astype(np.float64)
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        lo, hi = int(80 * len(seg) / sr), int(350 * len(seg) / sr)
        f0 = (lo + int(np.argmax(spec[lo:hi]))) * sr / len(seg)
        mos.append(float(np.clip(1.0 + 4.0 * (f0 - 100.0) / 200.0, 1.0, 5.0)))
    return np.round(mos, 2)


def load_golden(name: str):
    """A golden's (meta, state dict): the released weights it carries as ``sd::*``."""
    with np.load(os.path.join(GOLDENS, f"{name}.npz"), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    return meta, sd


def golden_tar(name: str, geometry: dict, path: str, label: str | None = None,
               seed: int | None = None) -> str:
    """A reference-format ``.tar`` at ``path`` holding golden ``name``'s
    weights and architecture at the front-end ``geometry``; returns ``path``.

    With ``seed``, every floating tensor of the weights is multiplied by
    1 + 0.05 N(0, 1), drawn from ``np.random.default_rng(seed)`` in
    state-dict order: a seeded model of the released architecture and
    scale that is not the released one, with the same bytes on every
    machine. (AdaptCNN's adaptive pools let NISQA_DIM's weights take any
    mel height.)"""
    meta, sd = load_golden(name)
    if seed is not None:
        rng = np.random.default_rng(seed)
        sd = {k: v * torch.from_numpy((1 + 0.05 * rng.standard_normal(tuple(v.shape)))
                                      .astype(np.float32))
              if v.is_floating_point() else v for k, v in sd.items()}
    model = meta["model"]
    args = {**meta["model_args"], **geometry, "model": model, "name": label or model}
    torch.save({"args": args, "model_state_dict": sd, "model_name": model}, path)
    return path
