"""Attention pooling heads over time: PoolAtt and PoolAttFF.

Counterpart of ``nisqa_tpu/models/pooling.py`` (kinds ``att`` and
``att_ff``): a masked softmax over T weights the frames, then a linear
layer maps the pooled vector to the output. The other pool kinds (avg, max,
last_step, last_step_bi) are not ported yet and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import length_mask


def _attend(score, x, n_wins):
    """score (B, T), x (B, T, D) -> masked-softmax-weighted sum (B, D)."""
    score = score.masked_fill(~length_mask(n_wins, x.shape[1]), -torch.inf)
    return (torch.softmax(score, dim=1)[:, None, :] @ x)[:, 0]


class PoolAtt(nn.Module):
    def __init__(self, d_input: int, output_size: int):
        super().__init__()
        self.linear1 = nn.Linear(d_input, 1)
        self.linear2 = nn.Linear(d_input, output_size)

    def forward(self, x, n_wins):
        return self.linear2(_attend(self.linear1(x)[..., 0], x, n_wins))


class PoolAttFF(nn.Module):
    def __init__(self, d_input: int, output_size: int, att_h: int):
        super().__init__()
        self.linear1 = nn.Linear(d_input, att_h)
        self.linear2 = nn.Linear(att_h, 1)
        self.linear3 = nn.Linear(d_input, output_size)

    def forward(self, x, n_wins):
        score = self.linear2(F.relu(self.linear1(x)))[..., 0]
        return self.linear3(_attend(score, x, n_wins))


class Pooling(nn.Module):
    """Dispatcher holding ``.model``: PoolAttFF when ``att_h`` is set, else PoolAtt."""

    def __init__(self, d_input: int, output_size: int, pool: str, att_h=None):
        super().__init__()
        if pool != "att":
            raise NotImplementedError(f"Pool option {pool!r} is not ported yet (ROADMAP.md Queue 1)")
        if att_h is None:
            self.model = PoolAtt(d_input, output_size)
        else:
            self.model = PoolAttFF(d_input, output_size, int(att_h))

    def forward(self, x, n_wins):
        return self.model(x, n_wins)
