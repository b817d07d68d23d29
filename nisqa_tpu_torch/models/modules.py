"""Shared building blocks: length masks and masked multi-head self-attention.

Counterparts of ``nisqa_tpu/models/modules.py::length_mask`` and ``mha``.
Attention is written out (projection, masked softmax, weighted sum) rather
than taken from ``nn.MultiheadAttention`` / ``nn.TransformerEncoderLayer``:
in eval with a padding mask those take a nested-tensor fast path that
zeroes padded positions and changes the numerics.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def length_mask(n_wins, t: int):
    """(B,) lengths -> (B, T) bool validity mask."""
    return torch.arange(t, device=n_wins.device)[None, :] < n_wins[:, None]


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention self-attention with a key-padding mask.

    Parameter names are the reference's (``in_proj_weight`` (3D, D),
    ``in_proj_bias``, ``out_proj``), so its checkpoints load unchanged.
    """

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, key_valid):
        """x (B, T, D), key_valid (B, T) bool (True = attendable) -> (B, T, D)."""
        b, t, d = x.shape
        dh = d // self.nhead
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (z.reshape(b, t, self.nhead, dh).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores.masked_fill(~key_valid[:, None, None, :], -torch.inf)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))
