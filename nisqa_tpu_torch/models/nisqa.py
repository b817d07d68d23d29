"""Top-level model families: NISQA, NISQA_DIM and NISQA_DE.

Counterpart of ``nisqa_tpu/models/nisqa.py``:

  * NISQA     : framewise -> td -> td_2 -> pool                  -> (B, 1)
  * NISQA_DIM : shared trunk + 5 pooling heads [mos,noi,dis,col,loud]
                                                                 -> (B, 5)
  * NISQA_DE  : shared framewise -> td on the degraded and the reference
                end, alignment of the reference to the degraded end,
                fusion, td_2, pool                               -> (B, 1)

The module tree follows the reference's state-dict names (``cnn.model.*``,
``time_dependency.model.*``, ``align.att.*``, ``fuse.lin_fusion``,
``time_dependency_2``, ``pool.model.*`` / ``pool_layers.{i}.model.*``), so
released ``.tar`` checkpoints load with ``strict=True`` and no key
converter. Every framewise, time-dependency, alignment, fusion and pooling
option is here. In train mode ``row_valid`` (B,) keeps rows out of the batch
statistics, every dropout draws from the generator that
:meth:`NISQA.set_dropout_generator` gives the model, and batch norm takes
its statistics over the ranks of the group :meth:`NISQA.set_process_group`
gives it.
"""

from __future__ import annotations

import torch
from torch import nn

from .align import Alignment, Fusion
from .framewise import Framewise
from .modules import set_dropout_generator, set_process_group
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
        self.time_dependency_2 = TimeDependency(self._td2_in(cfg), cfg, "td_2")
        self._init_pool(cfg)

    def _td2_in(self, cfg) -> int:
        """Input width of td_2. NISQA_DE builds its alignment and fusion
        here, so they register before td_2 as in the reference."""
        return self.time_dependency.fan_out

    def _init_pool(self, cfg):
        self.pool = Pooling(self.time_dependency_2.fan_out, 1, cfg.get("pool", "att"),
                            cfg.get("pool_att_h"), _pool_dropout(cfg))

    def set_dropout_generator(self, generator):
        """Every dropout of the model draws from ``generator`` (a
        ``torch.Generator`` on the model's device; None: the global one)."""
        set_dropout_generator(self, generator)

    def set_process_group(self, group):
        """Train-mode batch norm takes its statistics over the ranks of
        ``group`` (a ``torch.distributed`` process group; None: this
        process's rows alone)."""
        set_process_group(self, group)

    def _trunk(self, x, n_wins, row_valid=None):
        h = self.time_dependency(self.cnn(x, n_wins, row_valid), n_wins)
        return self.time_dependency_2(h, n_wins)

    def forward(self, x, n_wins, row_valid=None):
        return self.pool(self._trunk(x, n_wins, row_valid), n_wins)


class NISQA_DIM(NISQA):
    """forward(x, n_wins) -> (B, 5): [mos, noi, dis, col, loud]."""

    name = "NISQA_DIM"
    dim = True

    def _init_pool(self, cfg):
        # the reference sizes the heads from the td (not td_2) fan-out
        # (nisqa_tpu/models/nisqa.py:84-93); identical when td_2 is skip
        self.pool_layers = nn.ModuleList(
            Pooling(self.time_dependency.fan_out, 1, cfg.get("pool", "att"), cfg.get("pool_att_h"),
                    _pool_dropout(cfg))
            for _ in DIM_TARGETS
        )

    def forward(self, x, n_wins, row_valid=None):
        h = self._trunk(x, n_wins, row_valid)
        return torch.cat([pool(h, n_wins) for pool in self.pool_layers], dim=1)


class NISQA_DE(NISQA):
    """forward(x (B, T, 2, n_mels, seg_length), n_wins (B, 2)) -> (B, 1),
    channel 0 the degraded end and channel 1 the reference, as in the
    reference; :meth:`forward_ends` takes the two ends apart."""

    name = "NISQA_DE"
    double_ended = True

    def _td2_in(self, cfg) -> int:
        d = self.time_dependency.fan_out
        self.align = Alignment(cfg.get("de_align"), cfg.get("de_align_apply", "hard"), d, d)
        self.fuse = Fusion(cfg.get("de_fuse"), d, cfg.get("de_fuse_dim"))
        return self.fuse.fan_out

    def forward(self, x, n_wins, row_valid=None):
        return self.forward_ends(x[:, :, 0], n_wins[:, 0], x[:, :, 1], n_wins[:, 1], row_valid)

    def trunk_ends(self, deg, n_deg, ref, n_ref, row_valid=None):
        """The shared framewise + td features of both ends, (B, T, D) each.
        In eval every stage acts row by row, so the trunk runs once over
        both ends' 2B rows. In train mode it runs twice, degraded end first,
        so that BN's running statistics take the reference's serial
        update."""
        if self.training:
            return (self.time_dependency(self.cnn(deg, n_deg, row_valid), n_deg),
                    self.time_dependency(self.cnn(ref, n_ref, row_valid), n_ref))
        n = torch.cat([n_deg, n_ref])
        return self.time_dependency(self.cnn(torch.cat([deg, ref])), n).split(deg.shape[0])

    def forward_ends(self, deg, n_deg, ref, n_ref, row_valid=None):
        """(deg (B, T, M, S), n_deg (B,), ref (B, T, M, S), n_ref (B,)) ->
        (B, 1)."""
        fd, fr = self.trunk_ends(deg, n_deg, ref, n_ref, row_valid)
        h = self.time_dependency_2(self.fuse(fd, self.align(fd, fr, n_ref)), n_deg)
        return self.pool(h, n_deg)


def _pool_dropout(cfg) -> float:
    return float(cfg.get("pool_att_dropout") or 0.0)


def build_model(model_name: str, model_args: dict) -> nn.Module:
    """Factory over the reference's model names."""
    if model_name == "NISQA":
        return NISQA(model_args)
    if model_name == "NISQA_DIM":
        return NISQA_DIM(model_args)
    if model_name == "NISQA_DE":
        return NISQA_DE(model_args)
    raise NotImplementedError(f"Model not available: {model_name}")
