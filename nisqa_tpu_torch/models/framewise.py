"""Framewise (per-segment) models: AdaptCNN, StandardCNN, DFF, Skip.

Counterpart of ``nisqa_tpu/models/framewise.py``. All B*T segments run
densely as one NCHW batch (B*T, 1, n_mels, seg_length); padded segments are
masked downstream, which is output-equivalent in eval. In train mode every
batch norm takes its statistics over the valid segments only
(:func:`.modules.masked_batch_norm`, the validity ``w`` of each of the B*T
rows; over the ranks of the process group that
:func:`.modules.set_process_group` gives it) and the reference's dropout
applies; eval runs the ``nn.BatchNorm*`` modules as they are, except that
every AdaptCNN block in eval without autograd (serving, validation) runs its
convolution without the bias and then a hand-written epilogue that adds the
bias and applies the batch norm and ReLU in one pass:
:func:`..ops.bn_relu_pool.bn_relu_adaptive_max_pool`, with the pool, at
blocks 1, 2 and 4, and :func:`..ops.bn_relu_pool.bias_bn_relu` at blocks 3,
5 and 6. Flattened
features use torch's channel-major order, and the module names are the reference's (StandardCNN's fc is ``fc_out``, Skip's
is ``linear``), so released checkpoints load unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_relu_pool import bias_bn_relu, bn_relu_adaptive_max_pool
from .modules import dropout, dropout2d, length_mask, masked_batch_norm, max_pool2d


def _kernel_hw(kernel_size):
    if isinstance(kernel_size, int):
        return kernel_size, kernel_size
    return int(kernel_size[0]), int(kernel_size[1])


class _Stage(nn.Module):
    """A framewise model: ``forward(x (N, 1, H, W), w=None)``, ``w`` the (N,)
    validity of the rows for train-mode batch statistics (None: all)."""

    def __init__(self, cfg: dict):
        super().__init__()
        # the JAX package's default when the key is absent
        self.dropout_p = float(cfg.get("cnn_dropout", 0.2) or 0.0)
        self.generator = None
        self.group = None  # the process group of train-mode batch statistics

    def _bn(self, bn, x, w):
        return masked_batch_norm(x, bn, w, self.group) if self.training else bn(x)

    def _drop2d(self, x):
        return dropout2d(x, self.dropout_p, self.training, self.generator)


class AdaptCNN(_Stage):
    """Six conv+BN+ReLU blocks with adaptive max-pools; Dropout2d before
    blocks 3 to 6 in train mode."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        kh, kw = _kernel_hw(cfg["cnn_kernel_size"])
        c1, c2, c3 = int(cfg["cnn_c_out_1"]), int(cfg["cnn_c_out_2"]), int(cfg["cnn_c_out_3"])
        self.pools = [tuple(int(v) for v in cfg[f"cnn_pool_{i}"]) for i in (1, 2, 3)]
        pad_w = 0 if kw == 1 else 1
        chans = [(1, c1), (c1, c2), (c2, c3), (c3, c3), (c3, c3)]
        for i, (ci, co) in enumerate(chans, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(ci, co, (kh, kw), padding=(1, pad_w)))
            setattr(self, f"bn{i}", nn.BatchNorm2d(co))
        # kernel (kh, pool_3 width) collapses the width to 1
        self.conv6 = nn.Conv2d(c3, c3, (kh, self.pools[2][1]), padding=(1, 0))
        self.bn6 = nn.BatchNorm2d(c3)
        self.fan_out = c3 * self.pools[2][0]
        if cfg.get("cnn_fc_out_h"):
            self.fc = nn.Linear(self.fan_out, int(cfg["cnn_fc_out_h"]))
            self.fan_out = int(cfg["cnn_fc_out_h"])
        else:
            self.fc = None

    def _chain(self, i, x, w):
        """Block ``i`` through its modules: the train step, and any forward
        with autograd."""
        return F.relu(self._bn(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(x), w))

    def _epilogue_inputs(self, i, x):
        """Block ``i``'s convolution run without its bias, then the
        epilogue's per-channel inputs: that bias, the batch norm's running
        statistics and affine, all read at call time; and its eps."""
        conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)
        return y, conv.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps

    def _block(self, i, x, w):
        """Block ``i``: convolution, batch norm, ReLU. In eval without
        autograd the bias, batch norm and ReLU are one op over the output of
        the convolution run without its bias."""
        if self.training or torch.is_grad_enabled():
            return self._chain(i, x, w)
        return bias_bn_relu(*self._epilogue_inputs(i, x))

    def _pooled_block(self, i, x, w, pool):
        """Block ``i`` and its adaptive max-pool. In eval without autograd
        the bias, batch norm, ReLU and pool are one op over the output of
        the convolution run without its bias."""
        if self.training or torch.is_grad_enabled():
            return F.adaptive_max_pool2d(self._chain(i, x, w), pool)
        return bn_relu_adaptive_max_pool(*self._epilogue_inputs(i, x), pool)

    def forward(self, x, w=None):
        """x (N, 1, H, W) -> (N, fan_out); channel-major flatten like torch."""
        x = self._pooled_block(1, x, w, self.pools[0])
        x = self._pooled_block(2, x, w, self.pools[1])
        x = self._block(3, self._drop2d(x), w)
        x = self._pooled_block(4, self._drop2d(x), w, self.pools[2])
        x = self._block(6, self._drop2d(self._block(5, self._drop2d(x), w)), w).flatten(1)
        return self.fc(x) if self.fc is not None else x


class StandardCNN(_Stage):
    """Six 3x3 conv+BN+ReLU blocks with 2x2 max-pools (48x15 -> 6x2), the
    released NISQA-TTS model's framewise stage; Dropout2d before blocks 3 to
    6 in train mode."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        c1, c2, c3 = int(cfg["cnn_c_out_1"]), int(cfg["cnn_c_out_2"]), int(cfg["cnn_c_out_3"])
        chans = [(1, c1), (c1, c2), (c2, c3), (c3, c3), (c3, c3), (c3, c3)]
        for i, (ci, co) in enumerate(chans, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(ci, co, 3, padding=1))
            setattr(self, f"bn{i}", nn.BatchNorm2d(co))
        self.fan_out = c3 * 6 * 2
        if cfg.get("cnn_fc_out_h"):
            self.fc_out = nn.Linear(self.fan_out, int(cfg["cnn_fc_out_h"]))
            self.fan_out = int(cfg["cnn_fc_out_h"])
        else:
            self.fc_out = None

    def _block(self, i, x, w):
        return F.relu(self._bn(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(x), w))

    def forward(self, x, w=None):
        x = max_pool2d(self._block(1, x, w), pad_w=1)  # 48x15 -> 24x8
        x = max_pool2d(self._block(2, x, w))  # -> 12x4
        x = max_pool2d(self._block(4, self._drop2d(self._block(3, self._drop2d(x), w)), w))  # -> 6x2
        x = self._block(6, self._drop2d(self._block(5, self._drop2d(x), w)), w).flatten(1)
        return self.fc_out(x) if self.fc_out is not None else x


class DFF(_Stage):
    """Feed-forward baseline: BN over the one input channel, flatten, then
    four Linear+BN+ReLU layers of ``cnn_fc_out_h`` units, dropout after the
    first three in train mode."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        if not cfg.get("cnn_fc_out_h"):
            raise ValueError("cnn_model='dff' requires cnn_fc_out_h to be set")
        h = self.fan_out = int(cfg["cnn_fc_out_h"])
        fan_in = int(cfg["ms_seg_length"]) * int(cfg["ms_n_mels"])
        for i in range(1, 5):
            setattr(self, f"lin{i}", nn.Linear(fan_in if i == 1 else h, h))
        self.bn1 = nn.BatchNorm2d(1)
        for i in range(2, 6):
            setattr(self, f"bn{i}", nn.BatchNorm1d(h))

    def forward(self, x, w=None):
        x = self._bn(self.bn1, x, w).flatten(1)
        for i in range(1, 5):
            x = F.relu(self._bn(getattr(self, f"bn{i + 1}"), getattr(self, f"lin{i}")(x), w))
            if i < 4:
                x = dropout(x, self.dropout_p, self.training, self.generator)
        return x


class Skip(_Stage):
    """BN over the one input channel and flatten, plus an optional Linear."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.bn = nn.BatchNorm2d(1)
        self.fan_out = int(cfg["ms_seg_length"]) * int(cfg["ms_n_mels"])
        if cfg.get("cnn_fc_out_h"):
            self.linear = nn.Linear(self.fan_out, int(cfg["cnn_fc_out_h"]))
            self.fan_out = int(cfg["cnn_fc_out_h"])
        else:
            self.linear = None

    def forward(self, x, w=None):
        x = self._bn(self.bn, x, w).flatten(1)
        return self.linear(x) if self.linear is not None else x


FRAMEWISE = {"adapt": AdaptCNN, "standard": StandardCNN, "dff": DFF, "skip": Skip}


class Framewise(nn.Module):
    """Dispatcher holding ``.model`` (state-dict prefix ``cnn.model.*``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        kind = cfg.get("cnn_model") or "skip"
        if kind == "standard":
            if int(cfg["ms_n_mels"]) != 48 or int(cfg["ms_seg_length"]) != 15:
                raise ValueError("StandardCNN requires 48 mels x seg_length 15")
            if _kernel_hw(cfg["cnn_kernel_size"]) != (3, 3):
                raise ValueError("StandardCNN requires kernel_size 3")
        if kind not in FRAMEWISE:
            raise NotImplementedError(f"Framewise model not available: {kind}")
        self.model = FRAMEWISE[kind](cfg)
        self.fan_out = self.model.fan_out

    def forward(self, segs, n_wins=None, row_valid=None):
        """segs (B, T, H, S) -> features (B, T, fan_out). In train mode the
        batch statistics take the segments ``t < n_wins`` (all when None) of
        the rows where ``row_valid`` (B,) is true (all when None)."""
        b, t, h, s = segs.shape
        x = segs.reshape(b * t, 1, h, s)
        if not self.training:
            return self.model(x).reshape(b, t, -1)
        valid = (length_mask(n_wins, t) if n_wins is not None
                 else segs.new_ones((b, t), dtype=bool))
        if row_valid is not None:
            valid = valid & row_valid[:, None]
        return self.model(x, valid.reshape(b * t)).reshape(b, t, -1)
