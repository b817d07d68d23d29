"""Double-ended alignment and fusion.

Counterpart of ``nisqa_tpu/models/align.py``: five similarity scorers (dot,
cosine, distance, bahd, luong) or none, hard (argmax + gather) or soft
(softmax + product) application, and the fusions x/y/-, +/- and x/y with an
optional linear ``fuse_dim`` projection. Parameter names are the
reference's (``align.att.Wq`` / ``Wy`` / ``v``, ``align.att.W``,
``fuse.lin_fusion``), so its checkpoints load with ``strict=True``.

The products run as ``bmm``. The scorers that the JAX package writes as a
(B, Tq, Ty, D) broadcast reduction, which XLA fuses, run here over chunks of
query rows, so that eager PyTorch never holds that tensor whole: at T 1,300
and bs 32 it would be 13.8 GB for distance and 27.7 GB for bahd.
"""

from __future__ import annotations

import torch
from torch import nn

from .modules import length_mask

# bytes of one chunk's (B, rows, Ty, width) temporary in distance / bahd
_CHUNK_BYTES = 512 << 20


def _by_query_chunks(q, y, fn, width: int):
    """``fn(q rows, y) -> (B, rows, Ty)`` over chunks of q's rows, each
    chunk's (B, rows, Ty, width) temporary under ``_CHUNK_BYTES``."""
    b, tq = q.shape[:2]
    ty = y.shape[1]
    rows = max(1, _CHUNK_BYTES // (b * ty * width * q.element_size()))
    if rows >= tq:
        return fn(q, y)
    out = q.new_empty((b, tq, ty))
    for i in range(0, tq, rows):
        out[:, i : i + rows] = fn(q[:, i : i + rows], y)
    return out


class Alignment(nn.Module):
    """forward(q (B, Tq, D) degraded, y (B, Ty, D) reference, n_y (B,)) ->
    y aligned to q, (B, Tq, D)."""

    def __init__(self, method, apply_method, q_dim: int, y_dim: int, att_dim: int = 128):
        super().__init__()
        if method not in ("dot", "cosine", "distance", "bahd", "luong", "none", None):
            raise NotImplementedError(f"alignment method not available: {method}")
        if method not in ("none", None) and apply_method not in ("hard", "soft"):
            raise NotImplementedError(f"alignment apply method not available: {apply_method}")
        self.method, self.apply_method = method, apply_method
        if method == "bahd":
            self.att = nn.ModuleDict({"Wq": nn.Linear(q_dim, att_dim),
                                      "Wy": nn.Linear(y_dim, att_dim),
                                      "v": nn.Linear(att_dim, 1)})
        elif method == "luong":
            self.att = nn.ModuleDict({"W": nn.Linear(y_dim, q_dim)})

    def scores(self, q, y):
        """(B, Tq, Ty) similarity of every query row to every key row."""
        method = self.method
        if method == "dot":
            return torch.bmm(q, y.transpose(1, 2))
        if method == "luong":
            return torch.bmm(q, self.att["W"](y).transpose(1, 2))
        if method == "cosine":
            # each norm clamped at 1e-8 on its own (ATen's rule, which
            # nisqa_tpu pins), then one product of the normalised rows
            qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
            yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-8)
            return torch.bmm(qn, yn.transpose(1, 2))
        if method == "distance":
            # -mean_d |q - y|
            return _by_query_chunks(
                q, y, lambda qc, yy: (qc[:, :, None] - yy[:, None]).abs_().mean(-1).neg_(),
                q.shape[-1])
        # bahd: tanh(Wq q + Wy y) . v
        v = self.att["v"]
        wq, wy = self.att["Wq"](q), self.att["Wy"](y)
        return _by_query_chunks(
            wq, wy, lambda a, b: torch.matmul((a[:, :, None] + b[:, None]).tanh_(), v.weight[0])
            + v.bias[0], wq.shape[-1])

    def forward(self, q, y, n_y):
        if self.method in ("none", None):
            return y
        att = self.scores(q, y).masked_fill_(~length_mask(n_y, y.shape[1])[:, None, :], -torch.inf)
        if self.apply_method == "hard":
            idx = att.argmax(dim=2)  # the first maximum, as jnp.argmax
            return torch.gather(y, 1, idx[:, :, None].expand(-1, -1, y.shape[2]))
        return torch.bmm(torch.softmax(att, dim=2), y)


class Fusion(nn.Module):
    """forward(x (B, T, D), y (B, T, D)) -> (B, T, fan_out)."""

    def __init__(self, fuse, in_feat: int, fuse_dim=None):
        super().__init__()
        if fuse not in ("x/y/-", "+/-", "x/y"):
            raise NotImplementedError(f"fuse mode not available: {fuse}")
        self.fuse = fuse
        self.fan_out = (3 if fuse == "x/y/-" else 2) * in_feat
        self.lin_fusion = None
        if fuse_dim:
            self.lin_fusion = nn.Linear(self.fan_out, int(fuse_dim))
            self.fan_out = int(fuse_dim)

    def forward(self, x, y):
        if self.fuse == "x/y/-":
            out = torch.cat([x, y, x - y], dim=2)
        elif self.fuse == "+/-":
            out = torch.cat([x + y, x - y], dim=2)
        else:
            out = torch.cat([x, y], dim=2)
        return out if self.lin_fusion is None else self.lin_fusion(out)
