"""One training epoch of the port against one of ``nisqa_tpu``, on the CPU.

The same args (a narrow model at a 48 kHz geometry, every dropout at 0,
"highest" precision) build a ``NisqaTPU`` and a ``NisqaTorch`` in mode
main over the same labelled corpus: nine 48 kHz PCM16 files and one at
16 kHz in the train db, three 48 kHz files in the validation db. The port's
model takes the JAX model's initial weights (``state_dict_from_jax``); both
``TrainEngine.run_epoch`` run unshuffled at bs 4, so the batch holding the
16 kHz file splits into one step per sample rate (4 steps). Bounds: the
epoch loss within 1e-4 relative, the epoch's train-mode predictions within
1e-3, and the trained models' predictions on the validation files within
1e-3. For ``train_mos`` (NISQA) and ``train_dim`` (NISQA_DIM, 5 targets).
Also the runners' data split and argument normalisation.

Adam moves a weight whose gradient is zero in exact arithmetic (a conv bias
ahead of a train-mode batch norm, the key bias of the attention, a bias of
the attention-pool score) by up to lr a step, in a direction set by float32
rounding noise, which differs between the two packages; through the BN
running means those biases reach the eval predictions. So the epoch runs at
lr 3e-5: the models' predictions then differ by 2.7e-4 for NISQA while the
epoch moves them by 0.022 (at lr 1e-3: 8.6e-3 and 0.30), and the test
checks that the move is over ten times the bound.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from nisqa_tpu.audio.wav import write_wav
from nisqa_tpu.model import NisqaTPU
from nisqa_tpu.train import loop as jax_loop
from nisqa_tpu_torch.compat.jax_params import state_dict_from_jax
from nisqa_tpu_torch.model import NisqaTorch
from nisqa_tpu_torch.train import loop as port_loop
from tests.test_e2e import TINY_ARGS

DIMS = ("mos", "noi", "dis", "col", "loud")
# TINY_ARGS' widths at a 48 kHz geometry: n_fft 2048 covers the 960-sample
# window, and every file lands in the 44-segment bucket
EPOCH_ARGS = {
    **TINY_ARGS, "ms_n_fft": 2048, "ms_fmax": 8000.0, "cnn_dropout": 0.0, "td_sa_dropout": 0.0,
    "pool_att_dropout": 0.0, "precision": "highest", "tr_bs": 4, "tr_bs_val": 4, "tr_lr": 3e-5,
    "tr_num_workers": 2, "tr_parallel": False, "seed": 3, "csv_file": "corpus.csv",
    "csv_deg": "filename", "csv_ref": "ref", "csv_mos_train": "mos", "csv_mos_val": "mos",
    "csv_db_train": ["T"], "csv_db_val": ["V"], "csv_con": None,
}


def write_corpus(tmp, n48=12, n16=1, seed=0):
    """``n48`` 48 kHz and ``n16`` 16 kHz PCM16 files of 0.78-0.9 s (tones
    plus noise; the 16 kHz ones go after the fifth file) and corpus.csv
    (filename, ref: the next file at the same rate, db: T for all but the
    last three 48 kHz files, V for those, and the five label columns)."""
    rng = np.random.default_rng(seed)
    names = []
    rates = [48000] * n48
    rates[5:5] = [16000] * n16
    for i, sr in enumerate(rates):
        t = np.arange(int(sr * rng.uniform(0.78, 0.9))) / sr
        y = 0.4 * np.sin(2 * np.pi * (150 + 45 * i) * t) + 0.05 * rng.standard_normal(len(t))
        names.append(f"f{i:02d}_{sr // 1000}k.wav")
        write_wav(str(tmp / names[-1]), y.astype(np.float32), sr)
    same = {sr: [n for n, r in zip(names, rates) if r == sr] for sr in set(rates)}
    ref = [same[sr][(same[sr].index(n) + 1) % len(same[sr])] for n, sr in zip(names, rates)]
    df = pd.DataFrame({"filename": names, "ref": ref,
                       "db": ["T"] * (len(names) - 3) + ["V"] * 3})
    for c in DIMS:
        df[c] = rng.uniform(1.0, 5.0, len(names)).round(2)
    df.to_csv(tmp / "corpus.csv", index=False)
    return names


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several workers on
    a shared CPU, where torch's default of a thread per core oversubscribes
    it and small ops slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_epoch")
    write_corpus(tmp)
    return tmp


def runners(corpus, model, **over):
    """(NisqaTPU, NisqaTorch) in mode main on the same args (``over``
    replacing some), the port's model holding the JAX model's initial
    weights."""
    args = {**EPOCH_ARGS, "model": model, "data_dir": str(corpus),
            "output_dir": str(corpus / "out"), "mode": "main", **over}
    jr = NisqaTPU(dict(args))
    pr = NisqaTorch({**args, "tr_device": "cpu"})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sd = state_dict_from_jax(to_np(jr.params), to_np(jr.state), model, pr.model.cfg)
    pr.model.load_state_dict(sd, strict=True)
    return jr, pr


def run_both(jr, pr, k):
    before = pr._engine().predict_paths(pr.ds_val.paths(), pr.ds_val.paths_ref())
    jeng, peng = jax_loop.TrainEngine(jr), port_loop.TrainEngine(pr)
    lr = EPOCH_ARGS["tr_lr"]
    loss_j, y_j = jeng.run_epoch(jr.ds_train, jax_loop._bias_losses(jr, k), lr,
                                 jax.random.PRNGKey(0), 4, shuffle=False)
    loss_p, y_p = peng.run_epoch(pr.ds_train, port_loop._bias_losses(pr, k), lr, 0, 4,
                                 shuffle=False)
    val_j = jr._engine().predict_paths(jr.ds_val.paths(), jr.ds_val.paths_ref())
    val_p = pr._engine().predict_paths(pr.ds_val.paths(), pr.ds_val.paths_ref())
    assert float(np.abs(val_p - before).max()) > 1e-2  # the epoch moved the predictions
    return (loss_j, y_j, val_j), (loss_p, y_p, val_p), peng


def check_epoch(jax_out, port_out, k):
    (loss_j, y_j, val_j), (loss_p, y_p, val_p) = jax_out, port_out
    assert y_p.shape == y_j.shape and y_p.shape[1] == k
    assert abs(loss_p - loss_j) <= 1e-4 * abs(loss_j), (loss_p, loss_j)
    assert float(np.abs(y_p - y_j).max()) <= 1e-3
    assert val_p.shape == val_j.shape == (len(val_p), k)
    assert float(np.abs(val_p - val_j).max()) <= 1e-3


@pytest.mark.parametrize("model,k,n_mels", [("NISQA", 1, None), ("NISQA_DIM", 5, None),
                                             ("NISQA_DIM", 5, 80)],
                         ids=["NISQA-1", "NISQA_DIM-5", "NISQA_DIM-5-mels80"])
def test_one_epoch_matches_jax(corpus, model, k, n_mels):
    """``n_mels`` 80: more bands than the kernel's 64-band tile (two chunks
    on the card), at this geometry's 342 kept bins."""
    jr, pr = runners(corpus, model, **({"ms_n_mels": n_mels} if n_mels else {}))
    assert pr.args["ms_n_mels"] == jr.args["ms_n_mels"] == (n_mels or TINY_ARGS["ms_n_mels"])
    jax_out, port_out, peng = run_both(jr, pr, k)
    check_epoch(jax_out, port_out, k)
    # 10 train files at bs 4: batches 4, 4 (48 + 16 kHz: two steps), 2
    assert peng.steps == 4 and peng.history[-1]["steps"] == 4
    assert pr.model.training  # the validation pass gave the train mode back


def test_train_split_and_args_match_jax(corpus):
    """The db split (with pandas' ``index`` column) and the argument
    normalisation: NISQA_DIM has no csv_mos_* column, a single-ended model
    no csv_ref."""
    for model in ("NISQA", "NISQA_DIM"):
        args = {**EPOCH_ARGS, "model": model, "data_dir": str(corpus), "mode": "main",
                "output_dir": str(corpus / "out")}
        jr, pr = NisqaTPU(dict(args)), NisqaTorch({**args, "tr_device": "cpu"})
        for key in ("dim", "double_ended", "csv_mos_train", "csv_mos_val", "csv_ref"):
            assert pr.args[key] == jr.args[key], key
        assert pr.runinfos == jr.runinfos
        for p_ds, j_ds in ((pr.ds_train, jr.ds_train), (pr.ds_val, jr.ds_val)):
            assert p_ds.df.columns == list(j_ds.df.columns)
            for c in p_ds.df.columns:
                assert list(p_ds.df[c]) == j_ds.df[c].tolist(), c
            assert p_ds.paths() == j_ds.paths()
            np.testing.assert_array_equal(p_ds.targets(), j_ds.targets())
    with pytest.raises(ValueError, match="Not all dbs found"):
        NisqaTorch({**args, "tr_device": "cpu", "csv_db_val": ["missing"]})


def test_fresh_model_leaves_the_global_generator():
    """Without pretrained_model the model is drawn from the args' seed
    under a forked generator: the same seed gives the same weights, and the
    global generator is where it was."""
    def build(seed):
        state = torch.random.get_rng_state()
        nisqa = NisqaTorch({**EPOCH_ARGS, "model": "NISQA", "mode": "predict_file", "deg": "x.wav",
                            "seed": seed, "tr_device": "cpu"})
        assert torch.equal(state, torch.random.get_rng_state())
        return nisqa.model.state_dict()

    a, b, c = build(1), build(1), build(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
