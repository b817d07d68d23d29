"""Every shipped training YAML trains end to end through the port's CLI.

``python -m nisqa_tpu_torch.run_train --yaml`` runs, in a subprocess on the
CPU (``--tr_device cpu``), each of the five configurations of
``nisqa_tpu/config/`` at its shipped architecture and full widths, with
``tests/test_train_all_configs.py``'s 48 kHz corpus and overrides (2 epochs,
``ms_max_segments`` 64). The two finetune configs warm-start from ``.tar``
files written here from ``g1_mos_only.npz`` and ``g2_dim.npz`` (the
released state dicts, ``sd::``). For each run:

  * the results CSV has 2 rows and the loss falls;
  * both epochs' ``.tar`` files exist, and the final one loads with
    ``strict=True`` into the port and into ``nisqa_tpu``'s
    ``load_model_from_tar``; the full-state ``.pt`` sits beside each;
  * the run YAML reads back with ``yaml.safe_load`` as the checkpoint's
    args (the run's args without ``now``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from nisqa_tpu.compat.torch_ckpt import load_model_from_tar as load_jax_model
from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from tests.test_train_all_configs import _overrides, corpus48  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "nisqa_tpu", "config")
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
CONFIGS = [
    # (yaml name, golden of the warm start or None, model the run trains)
    ("train_nisqa_cnn_sa_ap.yaml", None, "NISQA"),
    ("train_nisqa_cnn_lstm_avg.yaml", None, "NISQA"),
    ("train_nisqa_double_ended.yaml", None, "NISQA_DE"),
    ("finetune_nisqa.yaml", "g1_mos_only.npz", "NISQA"),
    ("finetune_nisqa_multidimensional.yaml", "g2_dim.npz", "NISQA_DIM"),
]


def _golden_tar(golden, path):
    """A reference-format .tar of a golden's released state dict."""
    z = np.load(os.path.join(GOLDEN_DIR, golden))
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    torch.save({"args": {**meta["model_args"], "model": meta["model"]}, "model_state_dict": sd,
                "model_name": meta["model"]}, path)
    return path


@pytest.mark.parametrize("cfg_name,golden,model_name", CONFIGS,
                         ids=[c[0].replace(".yaml", "") for c in CONFIGS])
def test_shipped_yaml_trains_through_the_port(corpus48, tmp_path, cfg_name, golden,  # noqa: F811
                                              model_name):
    with open(os.path.join(CONFIG_DIR, cfg_name)) as f:
        cfg = yaml.load(f, Loader=yaml.FullLoader)
    run_name = "port_" + cfg_name.replace(".yaml", "")
    cfg.update(_overrides(corpus48, tmp_path, run_name))
    cfg["pretrained_model"] = _golden_tar(golden, str(tmp_path / "warm.tar")) if golden else False
    cfg_path = tmp_path / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)

    # one intra-op thread: the suite's workers share the CPU
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "nisqa_tpu_torch.run_train", "--yaml", str(cfg_path),
                        "--tr_device", "cpu"], capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])

    (run,) = [d for d in os.listdir(tmp_path) if d.startswith(run_name + "_")]
    run_dir = tmp_path / run
    results = pd.read_csv(run_dir / f"{run}__results.csv")
    assert len(results) == 2
    losses = results["loss"].to_numpy(float)
    assert np.isfinite(losses).all()
    assert losses[1] < losses[0], f"{cfg_name}: loss did not fall: {losses}"

    tars = sorted(run_dir.glob("*.tar"))
    assert [t.name for t in tars] == [f"{run}__ep_001.tar", f"{run}__ep_002.tar"]
    for t in tars:
        assert t.with_suffix(".pt").exists()
    model, args = load_model_from_tar(str(tars[-1]))
    assert model.name == model_name and args["model"] == model_name
    jax_model, _, _, _ = load_jax_model(str(tars[-1]))
    assert jax_model.name == model_name

    with open(run_dir / f"{run}.yaml") as f:
        assert yaml.safe_load(f) == args
    assert "now" not in args and args["tr_device"] == "cpu"
    if model_name == "NISQA_DIM":
        assert args["csv_mos_train"] is None and args["csv_mos_val"] is None
    assert (args["csv_ref"] is None) == (model_name != "NISQA_DE")
