"""The work a cell asks for, counted from each file's own frames and
segments: not from the batches, buckets or padding a program runs.

FLOPs are two per multiply-add of the products the model's equations name
(convolutions with every tap of their zero padding, as cuDNN computes them;
linear layers; attention's scores and weighted sums), counted for a file of
``n`` segments with nothing padded. Elementwise work (batch norm,
activations, softmax, pooling, the magnitude, the dB) is not counted.

The DFT->mel step of a file of F frames: the DFT's 4 F span K (real and
imaginary products over the ``span`` samples of the analysis window and the
K bins the filterbank reads) and the mel step's 2 F nnz(filterbank). Its
bytes: the frames read once (bfloat16 in the fast mode, float32 in the
exact one) and the mel rows written once in float32.
"""

from __future__ import annotations

import numpy as np

from ..reference.nisqa_ref import mel_filterbank, n_wins


def _conv(c_in, c_out, kh, kw, h_out, w_out):
    return 2 * c_out * h_out * w_out * c_in * kh * kw


def cnn_flops_per_segment(cfg: dict) -> int:
    """AdaptCNN over one (n_mels, seg_length) segment."""
    kh, kw = cfg["cnn_kernel_size"]
    c1, c2, c3 = cfg["cnn_c_out_1"], cfg["cnn_c_out_2"], cfg["cnn_c_out_3"]
    (h1, w1), (h2, w2), (h3, w3) = (cfg[f"cnn_pool_{i}"] for i in (1, 2, 3))
    m, s = cfg["ms_n_mels"], cfg["ms_seg_length"]
    return (_conv(1, c1, kh, kw, m, s) + _conv(c1, c2, kh, kw, h1, w1)
            + _conv(c2, c3, kh, kw, h2, w2) + _conv(c3, c3, kh, kw, h2, w2)
            + _conv(c3, c3, kh, kw, h3, w3) + _conv(c3, c3, kh, w3, h3, 1))


def sa_flops(cfg: dict, n: int) -> int:
    """The self-attention stage over one file's n segments."""
    d, h = cfg["td_sa_d_model"], cfg["td_sa_h"]
    fan = cfg["cnn_c_out_3"] * cfg["cnn_pool_3"][0]
    per_layer = 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d + 2 * 2 * n * d * h
    return 2 * n * fan * d + cfg["td_sa_num_layers"] * per_layer


def pool_flops(cfg: dict, n: int) -> int:
    """One PoolAttFF head over n segments."""
    d, a = cfg["td_sa_d_model"], cfg["pool_att_h"]
    return 2 * n * d * a + 2 * n * a + 2 * n * d + 2 * d


def model_flops(cfg: dict, heads: int, n: int) -> int:
    """One eval forward over one file of n segments."""
    return n * cnn_flops_per_segment(cfg) + sa_flops(cfg, n) + heads * pool_flops(cfg, n)


class FrontEndWork:
    """The DFT->mel step's counts at one sample rate."""

    def __init__(self, cfg: dict, sr: int):
        self.hop = int(sr * float(cfg["ms_hop_length"]))
        self.span = int(sr * float(cfg["ms_win_length"]))
        fb = mel_filterbank(sr, int(cfg["ms_n_fft"]), int(cfg["ms_n_mels"]), float(cfg["ms_fmax"]))
        self.k = int(np.count_nonzero(fb.any(axis=0)))
        self.nnz = int(np.count_nonzero(fb))
        self.m = fb.shape[0]
        self.seg, self.seg_hop = int(cfg["ms_seg_length"]), int(cfg["ms_seg_hop_length"])

    def frames(self, n_samples: int) -> int:
        return 1 + int(n_samples) // self.hop

    def segments(self, n_samples: int) -> int:
        return n_wins(self.frames(n_samples), self.seg, self.seg_hop)

    def dft_flops(self, n_samples: int) -> int:
        return 4 * self.frames(n_samples) * self.span * self.k

    def mel_flops(self, n_samples: int) -> int:
        return 2 * self.frames(n_samples) * self.nnz

    def bytes(self, n_samples: int, fast: bool) -> int:
        f = self.frames(n_samples)
        return f * self.span * (2 if fast else 4) + f * self.m * 4


class Tally:
    """Work of files, summed: model FLOPs, DFT and mel FLOPs, kernel bytes."""

    def __init__(self, cfg: dict, heads: int, sr: int):
        self.cfg, self.heads, self.fe = cfg, heads, FrontEndWork(cfg, sr)

    def of(self, n_samples, fast: bool) -> dict:
        n_samples = [int(n) for n in n_samples]
        return {
            "model": sum(model_flops(self.cfg, self.heads, self.fe.segments(n)) for n in n_samples),
            "dft": sum(self.fe.dft_flops(n) for n in n_samples),
            "mel": sum(self.fe.mel_flops(n) for n in n_samples),
            "bytes": sum(self.fe.bytes(n, fast) for n in n_samples),
        }
