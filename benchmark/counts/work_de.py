"""The work of NISQA_DE pairs, counted from each end's own frames and
segments (``counts.work``'s convention), not from the program's batches,
buckets or padding.

A pair of a degraded end of n_d segments and a reference end of n_r: the
trunk (AdaptCNN and the first self-attention) over each end's own segments;
the cosine scores, 2 n_d n_r d (the normalisation is elementwise and not
counted; the hard alignment's argmax and gather are not products); the
``x/y/-`` fusion, which has no product without ``fuse_dim``; td_2 over the
degraded end's n_d rows of 3 d features; one PoolAttFF head over them. The
DFT->mel step and its bytes over both ends' frames.
"""

from __future__ import annotations

from ..reference.nisqa_de_ref import fused_dim
from .work import FrontEndWork, cnn_flops_per_segment, pool_flops, sa_flops


def td2_flops(cfg: dict, n: int) -> int:
    """td_2's self-attention over n rows of fused features."""
    d, h = cfg["td_2_sa_d_model"], cfg["td_2_sa_h"]
    per_layer = 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d + 2 * 2 * n * d * h
    return 2 * n * fused_dim(cfg) * d + cfg["td_2_sa_num_layers"] * per_layer


def pair_flops(cfg: dict, n_deg: int, n_ref: int) -> int:
    """One eval forward over a pair of n_deg and n_ref segments."""
    trunk = (n_deg + n_ref) * cnn_flops_per_segment(cfg) + sa_flops(cfg, n_deg) + sa_flops(cfg, n_ref)
    align = 2 * n_deg * n_ref * cfg["td_sa_d_model"]
    head = pool_flops({**cfg, "td_sa_d_model": cfg["td_2_sa_d_model"]}, n_deg)
    return trunk + align + td2_flops(cfg, n_deg) + head


class PairTally:
    """Work of pairs, summed: model FLOPs, DFT and mel FLOPs, kernel bytes."""

    def __init__(self, cfg: dict, sr: int):
        self.cfg, self.fe = cfg, FrontEndWork(cfg, sr)

    def of(self, n_deg, n_ref, fast: bool) -> dict:
        ends = [int(n) for n in n_deg] + [int(n) for n in n_ref]
        return {
            "model": sum(pair_flops(self.cfg, self.fe.segments(d), self.fe.segments(r))
                         for d, r in zip(n_deg, n_ref)),
            "dft": sum(self.fe.dft_flops(n) for n in ends),
            "mel": sum(self.fe.mel_flops(n) for n in ends),
            "bytes": sum(self.fe.bytes(n, fast) for n in ends),
        }
