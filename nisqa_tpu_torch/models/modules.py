"""Shared building blocks: length masks, masked multi-head self-attention,
the reference's 2x2 max-pool, the masked (packed-sequence) LSTM, and the
train-mode pieces: the masked batch norm (over the ranks of a process
group when it is given one) and dropout with an explicit generator.

Counterparts of ``nisqa_tpu/models/modules.py::length_mask``, ``mha``,
``max_pool2d``, ``lstm``, ``batchnorm`` (train mode), ``dropout`` and
``dropout2d``. Attention is written out (projection, masked softmax,
weighted sum) rather than taken from ``nn.MultiheadAttention`` /
``nn.TransformerEncoderLayer``: in eval with a padding mask those take a
nested-tensor fast path that zeroes padded positions and changes the
numerics.

Dropout draws its masks from the ``generator`` attribute of the module that
applies it (None: torch's global generator); :func:`set_dropout_generator`
gives one generator to every such module of a model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum


def length_mask(n_wins, t: int):
    """(B,) lengths -> (B, T) bool validity mask."""
    return torch.arange(t, device=n_wins.device)[None, :] < n_wins[:, None]


def masked_batch_norm(x, bn, w=None, group=None):
    """Train-mode ``bn`` (an ``nn.BatchNorm1d`` / ``2d``) over x (N, C, ...)
    with batch statistics over the rows whose validity ``w`` (N,) is true.

    The reference runs its framewise stage on the valid segments only
    (packed sequences); the dense batch here weights the statistics instead,
    with weighted sums and no boolean indexing (``x[mask]`` would wait for
    the device on every call). ``n = sum(w) * spatial``; the running
    statistics take the batch mean and the unbiased variance ``var * n /
    (n - 1)`` at the module's momentum, and ``num_batches_tracked`` counts
    the call, as torch's own train-mode batch norm does. ``bn``'s weight,
    bias and running buffers are used as they are, so no state-dict key
    changes.

    With a process ``group`` the statistics are those of the rows of every
    rank: n and the weighted sum go through one all-reduce, the weighted
    squared deviations from the global mean through a second, both
    differentiable (:func:`..parallel.mesh.all_reduce_sum`). The running
    statistics then update alike on every rank. A rank whose rows are all
    invalid still takes part.
    """
    dims = [0] + list(range(2, x.dim()))
    wb = (torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if w is None
          else w.to(x.dtype)).view(-1, *([1] * (x.dim() - 1)))
    n = wb.sum() * math.prod(x.shape[2:])
    s = (x * wb).sum(dims)
    if group is not None:
        ns = all_reduce_sum(torch.cat([n.view(1), s]), group)
        n, s = ns[0], ns[1:]
    mean = s / n
    shape = [1, -1] + [1] * (x.dim() - 2)
    centred = x - mean.view(shape)
    sq = (wb * centred * centred).sum(dims)
    if group is not None:
        sq = all_reduce_sum(sq, group)
    var = sq / n
    y = centred * torch.rsqrt(var + bn.eps).view(shape) * bn.weight.view(shape) + bn.bias.view(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean)
        bn.running_var.mul_(1.0 - m).add_(m * var * (n / torch.clamp(n - 1.0, min=1.0)))
        bn.num_batches_tracked.add_(1)
    return y


def dropout(x, p: float, training: bool, generator=None):
    """Elementwise dropout: zero with probability ``p``, scale the rest by
    1 / (1 - p); the identity in eval or at p = 0."""
    if not training or not p:
        return x
    keep = 1.0 - p
    return x * (torch.empty_like(x).bernoulli_(keep, generator=generator) / keep)


def dropout2d(x, p: float, training: bool, generator=None):
    """Channel dropout (``nn.Dropout2d``) on NCHW: one mask per (sample,
    channel) of shape (N, C, 1, 1)."""
    if not training or not p:
        return x
    keep = 1.0 - p
    mask = torch.empty((x.shape[0], x.shape[1], 1, 1), dtype=x.dtype, device=x.device)
    return x * (mask.bernoulli_(keep, generator=generator) / keep)


def set_dropout_generator(model: nn.Module, generator):
    """Every module of ``model`` that applies dropout draws from ``generator``."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def set_process_group(model: nn.Module, group):
    """Every module of ``model`` that applies train-mode batch norm takes
    its statistics over the ranks of ``group`` (None: this process alone)."""
    for m in model.modules():
        if hasattr(m, "group"):
            m.group = group


def max_pool2d(x, pad_w: int = 0):
    """torch MaxPool2d(2, stride=2, padding=(0, pad_w)) on NCHW (pads with -inf)."""
    return F.max_pool2d(x, 2, stride=2, padding=(0, pad_w))


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention self-attention with a key-padding mask.

    Parameter names are the reference's (``in_proj_weight`` (3D, D),
    ``in_proj_bias``, ``out_proj``), so its checkpoints load unchanged.
    """

    def __init__(self, d_model: int, nhead: int, dropout_p: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.nhead = nhead
        self.dropout_p = dropout_p
        self.generator = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, key_valid):
        """x (B, T, D), key_valid (B, T) bool (True = attendable) -> (B, T, D).
        In train mode the attention weights take dropout."""
        b, t, d = x.shape
        dh = d // self.nhead
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (z.reshape(b, t, self.nhead, dh).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores.masked_fill(~key_valid[:, None, None, :], -torch.inf)
        att = dropout(torch.softmax(scores, dim=-1), self.dropout_p, self.training, self.generator)
        return self.out_proj((att @ v).transpose(1, 2).reshape(b, t, d))


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
    In train mode every layer's output but the last takes dropout
    (``nn.LSTM(dropout=)``'s placement).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, bidirectional: bool,
                 dropout_p: float = 0.0):
        super().__init__()
        dirs = 2 if bidirectional else 1
        self.bidirectional = bidirectional
        self.dropout_p = dropout_p
        self.generator = None
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
        for k, lstm in enumerate(self.layers):
            if k:
                x = dropout(x, self.dropout_p, self.training, self.generator)
            if self.bidirectional:
                h = lstm.hidden_size
                y = lstm(torch.cat([x, _gather_t(x, to_right)]))[0]
                y = torch.cat([y[:b, :, :h], _gather_t(y[b:, :, h:], from_right)], dim=-1)
            else:
                y = lstm(x)[0]
            x = torch.where(valid, y, 0.0)
        return x
