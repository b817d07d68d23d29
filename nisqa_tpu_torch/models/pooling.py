"""Pooling heads over time: attention (PoolAtt, PoolAttFF), avg, max,
last step and bidirectional last step.

Counterpart of ``nisqa_tpu/models/pooling.py``: masked reductions over the
valid frames of (B, T, D), then a linear layer to the output. The frame
picks gather on the device with the lengths there (no host sync).
PoolAttFF's attention hidden layer takes dropout in train mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import dropout, length_mask


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
    def __init__(self, d_input: int, output_size: int, att_h: int, dropout_p: float = 0.0):
        super().__init__()
        self.linear1 = nn.Linear(d_input, att_h)
        self.linear2 = nn.Linear(att_h, 1)
        self.linear3 = nn.Linear(d_input, output_size)
        self.dropout_p = dropout_p
        self.generator = None

    def forward(self, x, n_wins):
        h = dropout(F.relu(self.linear1(x)), self.dropout_p, self.training, self.generator)
        score = self.linear2(h)[..., 0]
        return self.linear3(_attend(score, x, n_wins))


def _frame(x, idx):
    """x (B, T, D), idx (B,) -> x[b, idx[b]] (B, D)."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


class PoolReduce(nn.Module):
    """``avg``, ``max``, ``last_step`` or ``last_step_bi`` over the valid
    frames, then ``linear``. ``last_step_bi`` reads a biLSTM output laid
    out [forward, backward]: the forward half at t = n_wins - 1 and the
    backward half at t = 0."""

    def __init__(self, d_input: int, output_size: int, kind: str):
        super().__init__()
        self.kind = kind
        self.linear = nn.Linear(d_input, output_size)

    def forward(self, x, n_wins):
        if self.kind == "avg":
            valid = length_mask(n_wins, x.shape[1])[..., None]
            pooled = torch.where(valid, x, 0.0).sum(dim=1) / n_wins[:, None].to(x.dtype)
        elif self.kind == "max":
            valid = length_mask(n_wins, x.shape[1])[..., None]
            pooled = torch.where(valid, x, -torch.inf).amax(dim=1)
        elif self.kind == "last_step":
            pooled = _frame(x, n_wins - 1)
        else:
            h = x.shape[-1] // 2
            pooled = torch.cat([_frame(x[..., :h], n_wins - 1), x[:, 0, h:]], dim=1)
        return self.linear(pooled)


class Pooling(nn.Module):
    """Dispatcher holding ``.model``: for ``att``, PoolAttFF when ``att_h``
    is set, else PoolAtt; :class:`PoolReduce` for the other kinds."""

    def __init__(self, d_input: int, output_size: int, pool: str, att_h=None,
                 dropout_p: float = 0.0):
        super().__init__()
        if pool == "att":
            self.model = (PoolAtt(d_input, output_size) if att_h is None
                          else PoolAttFF(d_input, output_size, int(att_h), dropout_p))
        elif pool in ("avg", "max", "last_step", "last_step_bi"):
            self.model = PoolReduce(d_input, output_size, pool)
        else:
            raise NotImplementedError(f"Pool option not available: {pool}")

    def forward(self, x, n_wins):
        return self.model(x, n_wins)
