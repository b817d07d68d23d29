"""Training CLI of the PyTorch port: the JAX package's ``run_train.py`` (a
YAML config, argparse values over its keys) plus ``--tr_device``.

Example:
  python -m nisqa_tpu_torch.run_train --yaml nisqa_tpu/config/train_nisqa_cnn_sa_ap.yaml

The device defaults to CUDA (``tr_device`` in the YAML, or ``--tr_device``);
``cpu`` is the only way to train on the CPU. With ``tr_parallel: true`` (the
shipped YAMLs set it), ``torchrun`` trains over N cards, one process each:
  torchrun --standalone --nproc_per_node N -m nisqa_tpu_torch.run_train --yaml F
"""

from __future__ import annotations

import argparse

from .compat import yaml_lite
from .model import NisqaTorch
from .parallel.mesh import destroy_data_parallel


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.run_train")
    parser.add_argument("--yaml", required=True, type=str, help="YAML file with config")
    parser.add_argument("--tr_device", type=str,
                        help="torch device (default: the YAML's tr_device, else cuda)")
    cli = vars(parser.parse_args(argv))
    if cli["tr_device"] is None:
        del cli["tr_device"]
    return {**yaml_lite.load(cli["yaml"]), **cli}


def main(argv=None) -> NisqaTorch:
    """Trains as the CLI does; returns the runner (its ``train_engine`` holds
    the optimiser and the per-epoch history)."""
    nisqa = NisqaTorch(parse_args(argv))
    nisqa.train()
    return nisqa


if __name__ == "__main__":
    try:
        main()
    finally:
        destroy_data_parallel()
