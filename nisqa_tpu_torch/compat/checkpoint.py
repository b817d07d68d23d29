"""Reference-format ``.tar`` checkpoints -> port models.

Counterpart of ``nisqa_tpu/compat/torch_ckpt.py::load_torch_checkpoint`` and
``load_model_from_tar`` for every single-ended model (NISQA, NISQA_DIM with
any framewise, time-dependency and pooling option). The port's module tree
carries the reference's state-dict names, so loading is
``load_state_dict(strict=True)`` with no layout conversion.
"""

from __future__ import annotations

import torch

from ..models.nisqa import build_model
from .model_args import model_args_from_ckpt_args


def load_torch_checkpoint(path: str) -> dict:
    """.tar -> {'args': dict, 'state_dict': {name: tensor}}.

    ``weights_only=False``: reference checkpoints pickle a plain args dict
    beside the tensors, which torch >= 2.6 refuses by default.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {"args": dict(ckpt["args"]), "state_dict": ckpt["model_state_dict"]}


def build_from_args(args: dict) -> torch.nn.Module:
    """Model for a full (checkpoint) args dict, with untrained weights."""
    return build_model(args["model"], model_args_from_ckpt_args(args))


def load_model_from_tar(path: str, device="cpu"):
    """One call: .tar -> (eval-mode model on ``device``, checkpoint args)."""
    ckpt = load_torch_checkpoint(path)
    model = build_from_args(ckpt["args"])
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return model.to(device).eval(), ckpt["args"]
