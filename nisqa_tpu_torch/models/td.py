"""Time-dependency models: post-norm Transformer self-attention, skip.

Counterpart of ``nisqa_tpu/models/td.py`` (``self_attention_apply``,
``td_apply``): static (B, T, D) layout with a key-validity mask, residual
then LayerNorm as in the reference. LSTM and positional encoding are not
ported yet and raise.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .modules import MultiheadSelfAttention, length_mask


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, sa_h: int):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, sa_h)
        self.linear2 = nn.Linear(sa_h, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, h, key_valid):
        h = self.norm1(h + self.self_attn(h, key_valid))
        return self.norm2(h + self.linear2(F.relu(self.linear1(h))))


class SelfAttention(nn.Module):
    """Input projection + LayerNorm, then ``num_layers`` encoder layers."""

    def __init__(self, input_size: int, d_model: int, nhead: int, num_layers: int, sa_h: int):
        super().__init__()
        self.linear = nn.Linear(input_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.layers = nn.ModuleList(
            SelfAttentionLayer(d_model, nhead, sa_h) for _ in range(num_layers))

    def forward(self, x, n_wins):
        key_valid = length_mask(n_wins, x.shape[1])
        h = self.norm1(self.linear(x))
        for layer in self.layers:
            h = layer(h, key_valid)
        return h


class TimeDependency(nn.Module):
    """Dispatcher holding ``.model`` (``None`` for skip); ``prefix`` selects
    the ``td`` or ``td_2`` keys of the model args."""

    def __init__(self, input_size: int, cfg: dict, prefix: str = "td"):
        super().__init__()
        kind = cfg.get(prefix) or "skip"
        if kind == "self_att":
            if cfg.get(f"{prefix}_sa_pos_enc"):
                raise NotImplementedError(
                    "positional encoding is not ported yet (ROADMAP.md Queue 1)")
            d_model = int(cfg[f"{prefix}_sa_d_model"])
            self.model = SelfAttention(
                input_size, d_model, int(cfg[f"{prefix}_sa_nhead"]),
                int(cfg[f"{prefix}_sa_num_layers"]), int(cfg[f"{prefix}_sa_h"]))
            self.fan_out = d_model
        elif kind == "skip":
            self.model = None
            self.fan_out = input_size
        else:
            raise NotImplementedError(
                f"Time dependency {kind!r} is not ported yet (ROADMAP.md Queue 1)")

    def forward(self, x, n_wins):
        return x if self.model is None else self.model(x, n_wins)
