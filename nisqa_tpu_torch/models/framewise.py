"""Framewise (per-segment) models: AdaptCNN, StandardCNN, DFF, Skip.

Counterpart of ``nisqa_tpu/models/framewise.py``. All B*T segments run
densely as one NCHW batch (B*T, 1, n_mels, seg_length); padded segments are
masked downstream, which is output-equivalent in eval. Flattened features
use torch's channel-major order, and the module names are the reference's
(StandardCNN's fc is ``fc_out``, Skip's is ``linear``), so released
checkpoints load unchanged.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .modules import max_pool2d


def _kernel_hw(kernel_size):
    if isinstance(kernel_size, int):
        return kernel_size, kernel_size
    return int(kernel_size[0]), int(kernel_size[1])


class AdaptCNN(nn.Module):
    """Six conv+BN+ReLU blocks with adaptive max-pools; eval-mode forward."""

    def __init__(self, cfg: dict):
        super().__init__()
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

    def _block(self, i, x):
        return F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))

    def forward(self, x):
        """x (N, 1, H, W) -> (N, fan_out); channel-major flatten like torch."""
        x = F.adaptive_max_pool2d(self._block(1, x), self.pools[0])
        x = F.adaptive_max_pool2d(self._block(2, x), self.pools[1])
        x = self._block(4, self._block(3, x))
        x = F.adaptive_max_pool2d(x, self.pools[2])
        x = self._block(6, self._block(5, x)).flatten(1)
        return self.fc(x) if self.fc is not None else x


class StandardCNN(nn.Module):
    """Six 3x3 conv+BN+ReLU blocks with 2x2 max-pools (48x15 -> 6x2), the
    released NISQA-TTS model's framewise stage."""

    def __init__(self, cfg: dict):
        super().__init__()
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

    def _block(self, i, x):
        return F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))

    def forward(self, x):
        x = max_pool2d(self._block(1, x), pad_w=1)  # 48x15 -> 24x8
        x = max_pool2d(self._block(2, x))  # -> 12x4
        x = max_pool2d(self._block(4, self._block(3, x)))  # -> 6x2
        x = self._block(6, self._block(5, x)).flatten(1)
        return self.fc_out(x) if self.fc_out is not None else x


class DFF(nn.Module):
    """Feed-forward baseline: BN over the one input channel, flatten, then
    four Linear+BN+ReLU layers of ``cnn_fc_out_h`` units."""

    def __init__(self, cfg: dict):
        super().__init__()
        if not cfg.get("cnn_fc_out_h"):
            raise ValueError("cnn_model='dff' requires cnn_fc_out_h to be set")
        h = self.fan_out = int(cfg["cnn_fc_out_h"])
        fan_in = int(cfg["ms_seg_length"]) * int(cfg["ms_n_mels"])
        for i in range(1, 5):
            setattr(self, f"lin{i}", nn.Linear(fan_in if i == 1 else h, h))
        self.bn1 = nn.BatchNorm2d(1)
        for i in range(2, 6):
            setattr(self, f"bn{i}", nn.BatchNorm1d(h))

    def forward(self, x):
        x = self.bn1(x).flatten(1)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"lin{i}")(x)))
        return x


class Skip(nn.Module):
    """BN over the one input channel and flatten, plus an optional Linear."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.bn = nn.BatchNorm2d(1)
        self.fan_out = int(cfg["ms_seg_length"]) * int(cfg["ms_n_mels"])
        if cfg.get("cnn_fc_out_h"):
            self.linear = nn.Linear(self.fan_out, int(cfg["cnn_fc_out_h"]))
            self.fan_out = int(cfg["cnn_fc_out_h"])
        else:
            self.linear = None

    def forward(self, x):
        x = self.bn(x).flatten(1)
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

    def forward(self, segs):
        """segs (B, T, H, S) -> features (B, T, fan_out)."""
        b, t, h, s = segs.shape
        return self.model(segs.reshape(b * t, 1, h, s)).reshape(b, t, -1)
