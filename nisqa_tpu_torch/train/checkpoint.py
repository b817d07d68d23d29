"""Training checkpoints: the reference-format ``.tar`` and the full train state.

Counterpart of ``nisqa_tpu/train/checkpoint.py`` and the ``.tar`` writer
``nisqa_tpu/compat/torch_ckpt.py::save_torch_checkpoint``. Every save
writes two files:

  * ``<base>.tar``: the reference's checkpoint dict (``args`` without
    ``now``, ``model_state_dict``, ``model_name``, ``epoch``, ``results``),
    which the reference NISQA, ``nisqa_tpu`` and this port load with
    ``strict=True``;
  * ``<base>.pt``: the full train state for ``tr_resume``: the model's state
    dict (BN running statistics included), the optimiser's state dict, the
    bias-loss coefficients, the epoch and the LR-plateau / early-stopper
    state. It takes the place of the JAX package's flax ``.msgpack`` (which
    the port cannot read without flax), holds only tensors and plain Python
    values, and loads with ``weights_only=True``.
"""

from __future__ import annotations

import numpy as np
import torch


def save_train_state(path_base: str, model, optimizer, args: dict, epoch: int, bias_b, results: dict,
                     loop_state: dict):
    """``<path_base>.tar`` and ``<path_base>.pt`` after epoch ``epoch`` (0-based)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"args": {k: v for k, v in args.items() if k != "now"}, "model_state_dict": sd,
                "model_name": model.name, "epoch": epoch + 1, "results": results},
               path_base + ".tar")
    torch.save({"model_state_dict": sd, "optimizer": optimizer.state_dict(),
                "bias_b": torch.from_numpy(np.array(bias_b, np.float32)), "epoch": epoch + 1,
                "model": model.name, "loop_state": loop_state}, path_base + ".pt")


def load_train_state(path_base: str) -> dict:
    """The dict :func:`save_train_state` wrote to ``<path_base>.pt``."""
    return torch.load(path_base + ".pt", map_location="cpu", weights_only=True)
