"""Framewise (per-segment) model: AdaptCNN.

Counterpart of ``nisqa_tpu/models/framewise.py`` (``adapt_cnn_apply``,
``framewise_apply``). All B*T segments run densely as one NCHW batch
(B*T, 1, n_mels, seg_length); padded segments are masked downstream, which
is output-equivalent in eval. The other framewise kinds (standard, dff,
skip) are not ported yet and raise.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


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


class Framewise(nn.Module):
    """Dispatcher holding ``.model`` (state-dict prefix ``cnn.model.*``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        kind = cfg.get("cnn_model") or "skip"
        if kind != "adapt":
            raise NotImplementedError(
                f"Framewise model {kind!r} is not ported yet (ROADMAP.md Queue 1)")
        self.model = AdaptCNN(cfg)
        self.fan_out = self.model.fan_out

    def forward(self, segs):
        """segs (B, T, H, S) -> features (B, T, fan_out)."""
        b, t, h, s = segs.shape
        return self.model(segs.reshape(b * t, 1, h, s)).reshape(b, t, -1)
