"""NISQA_DE training against ``nisqa_tpu``, and resume, on the CPU.

One epoch of a small NISQA_DE (the test corpus widths, cosine / hard
alignment, x/y/- fusion, an SA td_2 of d_model 16) through the port's and
the JAX package's ``TrainEngine.run_epoch`` from the same weights, as in
``tests/test_torch_train_epoch.py``: eleven train pairs (two at 16 kHz, so
one batch splits by sample rate) at bs 4, every dropout at 0, unshuffled,
"highest"; the same bounds (loss 1e-4 relative, train-mode predictions and
the trained models' validation predictions 1e-3).

Resume: two epochs of ``NisqaTorch.train`` in a row, with the shipped
dropout rates and the shuffle on, equal one epoch, its checkpoint, and a
second epoch resumed from it (``tr_resume``): the second epoch's loss, the
weights, the BN statistics and Adam's state are bit-equal.
"""

import os

import pandas as pd
import pytest
import torch

from nisqa_tpu_torch.model import NisqaTorch
from tests.test_torch_train_epoch import (  # noqa: F401  (one_torch_thread: a fixture)
    EPOCH_ARGS, check_epoch, one_torch_thread, run_both, runners, write_corpus)
from tests.test_torch_train_jax import DE_ARGS


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_de")
    write_corpus(tmp, n48=12, n16=2, seed=4)
    return tmp


def test_de_epoch_matches_jax(corpus, monkeypatch):
    monkeypatch.setitem(EPOCH_ARGS, "td_2_sa_dropout", 0.0)
    for k, v in DE_ARGS.items():
        monkeypatch.setitem(EPOCH_ARGS, k, v)
    jr, pr = runners(corpus, "NISQA_DE")
    assert jr.ds_train.paths_ref() == pr.ds_train.paths_ref()
    jax_out, port_out, peng = run_both(jr, pr, 1)
    check_epoch(jax_out, port_out, 1)
    # 11 train pairs at bs 4: batches 4, 4 (two 48 kHz + two 16 kHz pairs: two steps), 3
    assert peng.steps == 4


def _train(corpus, out, **over):
    args = {**EPOCH_ARGS, "model": "NISQA", "mode": "main", "name": "resume",
            "data_dir": str(corpus), "output_dir": str(out), "tr_device": "cpu",
            "cnn_dropout": 0.2, "td_sa_dropout": 0.1, "pool_att_dropout": 0.1,
            "tr_lr": 1e-3, "tr_epochs": 2, "tr_early_stop": 10, "tr_lr_patience": 15,
            "tr_checkpoint": "every_epoch", "tr_verbose": 0, **over}
    NisqaTorch(args).train()
    (run,) = os.listdir(out)
    rows = pd.read_csv(out / run / f"{run}__results.csv")
    return out / run / f"{run}__ep_{len(rows) if 'tr_resume' not in over else 2:03d}", rows


def test_resume_equals_an_uninterrupted_run(corpus, tmp_path):
    straight, rows = _train(corpus, tmp_path / "straight")
    first, _ = _train(corpus, tmp_path / "first", tr_epochs=1)
    resumed, rows_r = _train(corpus, tmp_path / "resumed", tr_resume=str(first) + ".tar")
    assert len(rows) == 2 and len(rows_r) == 1 and rows_r["epoch"][0] == 2
    assert rows_r["loss"][0] == rows["loss"][1]
    a = torch.load(str(straight) + ".pt", weights_only=True)
    b = torch.load(str(resumed) + ".pt", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert a["loop_state"] == b["loop_state"]
    tar_a = torch.load(str(straight) + ".tar", weights_only=False)
    tar_b = torch.load(str(resumed) + ".tar", weights_only=False)
    for k, v in tar_a["model_state_dict"].items():
        assert torch.equal(v, tar_b["model_state_dict"][k]), k
