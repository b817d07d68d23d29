"""Time-dependency models: post-norm Transformer self-attention, LSTM, skip.

Counterpart of ``nisqa_tpu/models/td.py`` (``self_attention_apply``,
``td_apply``): static (B, T, D) layout with a key-validity mask, residual
then LayerNorm as in the reference, the optional sinusoidal positional
encoding added after the input LayerNorm, and the masked LSTM of
:class:`.modules.MaskedLSTM`. In train mode the self-attention takes the
reference encoder's dropout (after the positional encoding, on the
attention weights and output, on the feed-forward activation and output)
and the LSTM dropout between its layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .modules import MaskedLSTM, MultiheadSelfAttention, dropout, length_mask


def positional_encoding_table(d_model: int, max_len: int = 3000):
    """(max_len, d_model) float32 sinusoids, computed in float64 as the JAX
    package's table is."""
    pos = torch.arange(max_len, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


class PositionalEncoding(nn.Module):
    """Holds the reference's buffer ``pe`` in its seq-first layout
    (max_len, 1, d_model)."""

    def __init__(self, d_model: int, max_len: int = 3000):
        super().__init__()
        self.register_buffer("pe", positional_encoding_table(d_model, max_len)[:, None, :])

    def forward(self, h):
        """h (B, T, D) -> h + pe[:T]."""
        return h + self.pe[: h.shape[1], 0][None]


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, sa_h: int, dropout_p: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead, dropout_p)
        self.linear1 = nn.Linear(d_model, sa_h)
        self.linear2 = nn.Linear(sa_h, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.dropout_p = dropout_p
        self.generator = None

    def _drop(self, x):
        return dropout(x, self.dropout_p, self.training, self.generator)

    def forward(self, h, key_valid):
        h = self.norm1(h + self._drop(self.self_attn(h, key_valid)))
        return self.norm2(h + self._drop(self.linear2(self._drop(F.relu(self.linear1(h))))))


class SelfAttention(nn.Module):
    """Input projection + LayerNorm, then ``num_layers`` encoder layers."""

    def __init__(self, input_size: int, d_model: int, nhead: int, num_layers: int, sa_h: int,
                 pos_enc: bool = False, dropout_p: float = 0.0):
        super().__init__()
        self.linear = nn.Linear(input_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.layers = nn.ModuleList(
            SelfAttentionLayer(d_model, nhead, sa_h, dropout_p) for _ in range(num_layers))
        self.pos_encoder = PositionalEncoding(d_model) if pos_enc else None
        self.dropout_p = dropout_p
        self.generator = None

    def forward(self, x, n_wins):
        key_valid = length_mask(n_wins, x.shape[1])
        h = self.norm1(self.linear(x))
        if self.pos_encoder is not None:
            h = dropout(self.pos_encoder(h), self.dropout_p, self.training, self.generator)
        for layer in self.layers:
            h = layer(h, key_valid)
        return h


class LSTM(nn.Module):
    """Holds ``.lstm`` (state-dict prefix ``time_dependency.model.lstm.*``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, bidirectional: bool,
                 dropout_p: float = 0.0):
        super().__init__()
        self.lstm = MaskedLSTM(input_size, hidden_size, num_layers, bidirectional, dropout_p)

    def forward(self, x, n_wins):
        return self.lstm(x, n_wins)


class TimeDependency(nn.Module):
    """Dispatcher holding ``.model`` (``None`` for skip); ``prefix`` selects
    the ``td`` or ``td_2`` keys of the model args."""

    def __init__(self, input_size: int, cfg: dict, prefix: str = "td"):
        super().__init__()
        kind = cfg.get(prefix) or "skip"
        if kind == "self_att":
            d_model = int(cfg[f"{prefix}_sa_d_model"])
            self.model = SelfAttention(
                input_size, d_model, int(cfg[f"{prefix}_sa_nhead"]),
                int(cfg[f"{prefix}_sa_num_layers"]), int(cfg[f"{prefix}_sa_h"]),
                bool(cfg.get(f"{prefix}_sa_pos_enc")),
                float(cfg.get(f"{prefix}_sa_dropout") or 0.0))
            self.fan_out = d_model
        elif kind == "lstm":
            h = int(cfg[f"{prefix}_lstm_h"])
            bi = bool(cfg[f"{prefix}_lstm_bidirectional"])
            self.model = LSTM(input_size, h, int(cfg[f"{prefix}_lstm_num_layers"]), bi,
                              float(cfg.get(f"{prefix}_lstm_dropout") or 0.0))
            self.fan_out = (2 if bi else 1) * h
        elif kind == "skip":
            self.model = None
            self.fan_out = input_size
        else:
            raise NotImplementedError(f"Time dependency option not available: {kind}")

    def forward(self, x, n_wins):
        return x if self.model is None else self.model(x, n_wins)
