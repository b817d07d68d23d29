"""Shared building blocks: length masks, masked multi-head self-attention,
the reference's 2x2 max-pool and the masked (packed-sequence) LSTM.

Counterparts of ``nisqa_tpu/models/modules.py::length_mask``, ``mha``,
``max_pool2d`` and ``lstm``. Attention is written out (projection, masked
softmax, weighted sum) rather than taken from ``nn.MultiheadAttention`` /
``nn.TransformerEncoderLayer``: in eval with a padding mask those take a
nested-tensor fast path that zeroes padded positions and changes the
numerics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def length_mask(n_wins, t: int):
    """(B,) lengths -> (B, T) bool validity mask."""
    return torch.arange(t, device=n_wins.device)[None, :] < n_wins[:, None]


def max_pool2d(x, pad_w: int = 0):
    """torch MaxPool2d(2, stride=2, padding=(0, pad_w)) on NCHW (pads with -inf)."""
    return F.max_pool2d(x, 2, stride=2, padding=(0, pad_w))


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


def _gather_t(x, idx):
    """x (B, T, D), idx (B, T) -> x[b, idx[b, t]]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _flat_lstm_names(module, state_dict, prefix, local_metadata):
    """State-dict post hook: ``layers.{k}.<name>_l0[_reverse]`` ->
    ``<name>_l{k}[_reverse]``, torch.nn.LSTM's names for layer k."""
    for key in [k for k in state_dict if k.startswith(prefix + "layers.")]:
        k, name = key[len(prefix) + len("layers."):].split(".", 1)
        state_dict[prefix + name.replace("_l0", f"_l{k}")] = state_dict.pop(key)


def _layer_lstm_names(module, state_dict, prefix, *_):
    """Load-state-dict pre hook, the inverse of :func:`_flat_lstm_names`."""
    for k in range(len(module.layers)):
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            for sfx in ("", "_reverse"):
                key = f"{prefix}{name}_l{k}{sfx}"
                if key in state_dict:
                    state_dict[f"{prefix}layers.{k}.{name}_l0{sfx}"] = state_dict.pop(key)


class MaskedLSTM(nn.Module):
    """Stacked (bi)LSTM over (B, T, I) with per-row lengths, equivalent to
    torch's packed-sequence LSTM: steps ``t >= n_wins`` output zeros and
    never reach the carry, and the reverse direction's first step is
    ``t = n_wins - 1``. Output (B, T, H * dirs), [forward, backward].

    Each layer is one single-layer ``nn.LSTM`` call (cuDNN on the card) over
    the whole bucket; the lengths stay on the device (no host sync):

      * forward: the bucket runs as is; outputs past ``n_wins`` are zeroed
        (later steps never change earlier outputs);
      * bidirectional: the call takes 2B rows, the bucket and a copy with
        each row right-aligned (valid steps at T - n .. T-1), so the reverse
        direction of the copy starts at step n-1 with a zero carry. The
        forward half is read from the first B rows and the reverse half from
        the copy, gathered back to its own steps. Both directions run in
        one call.

    The state dict carries torch.nn.LSTM's names (``weight_ih_l{k}``,
    ``bias_hh_l{k}_reverse``, ...), so reference checkpoints load as they are.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, bidirectional: bool):
        super().__init__()
        dirs = 2 if bidirectional else 1
        self.bidirectional = bidirectional
        self.layers = nn.ModuleList(
            nn.LSTM(input_size if k == 0 else hidden_size * dirs, hidden_size,
                    batch_first=True, bidirectional=bidirectional)
            for k in range(num_layers))
        self.register_state_dict_post_hook(_flat_lstm_names)
        self.register_load_state_dict_pre_hook(_layer_lstm_names)

    def forward(self, x, n_wins):
        b, t, _ = x.shape
        steps = torch.arange(t, device=x.device)[None, :]
        valid = (steps < n_wins[:, None])[..., None]
        shift = (t - n_wins)[:, None]
        to_right, from_right = (steps - shift).clamp(min=0), (steps + shift).clamp(max=t - 1)
        for lstm in self.layers:
            if self.bidirectional:
                h = lstm.hidden_size
                y = lstm(torch.cat([x, _gather_t(x, to_right)]))[0]
                y = torch.cat([y[:b, :, :h], _gather_t(y[b:, :, h:], from_right)], dim=-1)
            else:
                y = lstm(x)[0]
            x = torch.where(valid, y, 0.0)
        return x
