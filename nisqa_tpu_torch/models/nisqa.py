"""Top-level model families: NISQA and NISQA_DIM.

Counterpart of ``nisqa_tpu/models/nisqa.py``:

  * NISQA     : framewise -> td -> td_2 -> pool                  -> (B, 1)
  * NISQA_DIM : shared trunk + 5 pooling heads [mos,noi,dis,col,loud]
                                                                 -> (B, 5)

The module tree follows the reference's state-dict names (``cnn.model.*``,
``time_dependency.model.*``, ``time_dependency_2``, ``pool.model.*`` /
``pool_layers.{i}.model.*``), so released ``.tar`` checkpoints load with
``strict=True`` and no key converter. Every framewise, time-dependency and
pooling option of the single-ended models is here; NISQA_DE is not ported
yet (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import torch
from torch import nn

from .framewise import Framewise
from .pooling import Pooling
from .td import TimeDependency

DIM_TARGETS = ("mos", "noi", "dis", "col", "loud")


class NISQA(nn.Module):
    """forward(x (B, T, n_mels, seg_length), n_wins (B,)) -> (B, 1)."""

    name = "NISQA"
    dim = False
    double_ended = False

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = dict(cfg)
        self.cnn = Framewise(cfg)
        self.time_dependency = TimeDependency(self.cnn.fan_out, cfg, "td")
        self.time_dependency_2 = TimeDependency(self.time_dependency.fan_out, cfg, "td_2")
        self._init_pool(cfg)

    def _init_pool(self, cfg):
        self.pool = Pooling(self.time_dependency_2.fan_out, 1, cfg.get("pool", "att"),
                            cfg.get("pool_att_h"))

    def _trunk(self, x, n_wins):
        h = self.time_dependency(self.cnn(x), n_wins)
        return self.time_dependency_2(h, n_wins)

    def forward(self, x, n_wins):
        return self.pool(self._trunk(x, n_wins), n_wins)


class NISQA_DIM(NISQA):
    """forward(x, n_wins) -> (B, 5): [mos, noi, dis, col, loud]."""

    name = "NISQA_DIM"
    dim = True

    def _init_pool(self, cfg):
        # the reference sizes the heads from the td (not td_2) fan-out
        # (nisqa_tpu/models/nisqa.py:84-93); identical when td_2 is skip
        self.pool_layers = nn.ModuleList(
            Pooling(self.time_dependency.fan_out, 1, cfg.get("pool", "att"), cfg.get("pool_att_h"))
            for _ in DIM_TARGETS
        )

    def forward(self, x, n_wins):
        h = self._trunk(x, n_wins)
        return torch.cat([pool(h, n_wins) for pool in self.pool_layers], dim=1)


def build_model(model_name: str, model_args: dict) -> nn.Module:
    """Factory over the reference's model names."""
    if model_name == "NISQA":
        return NISQA(model_args)
    if model_name == "NISQA_DIM":
        return NISQA_DIM(model_args)
    if model_name == "NISQA_DE":
        raise NotImplementedError("NISQA_DE is not ported yet (ROADMAP.md Queue 1 item 5)")
    raise NotImplementedError(f"Model not available: {model_name}")
