"""The port's device-resident training corpus (``tr_ds_to_memory``), on the CPU.

Counterpart of ``tests/test_train_device_cache.py``. A narrow model
(``TINY_ARGS``, 8 kHz) trains with ``tr_device="cpu"``, where the corpus is
built through the DFT->mel kernel's twin. Equal-length corpora (every file
1 s) put the host fill's batches in the bucket the corpus uses, so the two
fills run the same shapes and must agree to 1e-5; every dropout is 0 where
values are compared (the gather path pads time to the group's bucket, which
would draw other masks). The port's resident epoch is held to
``nisqa_tpu``'s resident ``run_epoch`` with the corpus, weights, bounds and
method of ``tests/test_torch_train_epoch.py``.

Partial residency: the budget counts rows padded to 64, so a cap of 70 rows
keeps a 64-row head resident. The epoch loss is one term per (batch, sample
rate) group; a group that straddles the partition takes a gather and a fill
sub-step, weighted by their rows in its term (``nisqa_tpu`` takes the plain
mean of the steps, ``loop.py:619``).
"""

import numpy as np
import pandas as pd
import pytest

from nisqa_tpu_torch.audio.wav import write_wav
from nisqa_tpu_torch.data import native
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from nisqa_tpu_torch.model import NisqaTorch
from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference
from nisqa_tpu_torch.train import loop as port_loop
from tests.test_e2e import TINY_ARGS
from tests.test_torch_train_epoch import (  # noqa: F401  (one_torch_thread: a fixture)
    EPOCH_ARGS, check_epoch, one_torch_thread, run_both, runners, write_corpus)
from tests.test_torch_train_jax import DE_ARGS

NO_DROPOUT = {"cnn_dropout": 0.0, "td_sa_dropout": 0.0, "pool_att_dropout": 0.0,
              "td_2_sa_dropout": 0.0}
SR = 8000
_MS = MsConfig(TINY_ARGS)
# the bytes of one 1 s file's mel row at its bucket
ROW_BYTES = _MS.frames_for_bucket(_MS.bucket_for(_MS.n_wins(_MS.n_frames(SR, SR)))) * _MS.n_mels * 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """80 PCM16 files of 1 s at 8 kHz (tones plus noise), one of 3 s
    (``long.wav``, over ``ms_max_segments``), and ``c<n>.csv``: the first n
    files, all db T, with a MOS column and each file's successor as its
    reference."""
    tmp = tmp_path_factory.mktemp("torch_train_device_cache")
    rng = np.random.default_rng(0)
    names = []
    for i in range(80):
        t = np.arange(SR) / SR
        y = 0.4 * np.sin(2 * np.pi * (200 + 60 * i) * t) + 0.05 * rng.standard_normal(len(t))
        names.append(f"s{i:02d}.wav")
        write_wav(str(tmp / names[-1]), y.astype(np.float32), SR)
    write_wav(str(tmp / "long.wav"), (0.1 * rng.standard_normal(3 * SR)).astype(np.float32), SR)
    mos = rng.uniform(1, 5, 80).round(2)
    for n in (6, 72, 80):
        pd.DataFrame({"filename": names[:n], "ref": names[1:n] + names[:1], "db": ["T"] * n,
                      "mos": mos[:n]}).to_csv(tmp / f"c{n}.csv", index=False)
    pd.DataFrame({"filename": ["long.wav"] + names[:5], "db": ["T"] * 6,
                  "mos": mos[:6]}).to_csv(tmp / "long.csv", index=False)
    return tmp


def make_runner(corpus, csv="c6.csv", model="NISQA", **over):
    """A port runner in mode main over ``csv`` (validation: the same files),
    its fresh model drawn from seed 0."""
    de = {**DE_ARGS, "csv_ref": "ref"} if model == "NISQA_DE" else {}
    return NisqaTorch({
        **TINY_ARGS, **NO_DROPOUT, **de, "model": model, "mode": "main", "tr_device": "cpu",
        "data_dir": str(corpus), "output_dir": str(corpus / "out"), "csv_file": csv,
        "csv_deg": "filename", "csv_mos_train": "mos", "csv_mos_val": "mos",
        "csv_db_train": ["T"], "csv_db_val": ["T"], "csv_con": None, "tr_lr": 1e-3,
        "tr_num_workers": 2, "seed": 0, **over})


def run_epochs(runner, n_epochs=1, bs=3, shuffle=True, engine=None):
    """[(loss, predictions)] of ``n_epochs`` epochs of ``runner``'s train set."""
    engine = engine or port_loop.TrainEngine(runner)
    runner.train_engine = engine
    bias = port_loop._bias_losses(runner, 1)
    return [engine.run_epoch(runner.ds_train, bias, 1e-3, ep, bs, shuffle=shuffle)
            for ep in range(n_epochs)]


def assert_epochs_close(out_a, out_b):
    for (la, ya), (lb, yb) in zip(out_a, out_b):
        np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ya, yb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["NISQA", "NISQA_DE"])
def test_resident_matches_host_fill(corpus, model):
    """Two shuffled epochs from the same weights, resident and host-filled:
    losses, train-mode predictions and weights within 1e-5."""
    res, host = (make_runner(corpus, model=model, tr_ds_to_memory=mem) for mem in (True, False))
    out_res, out_host = run_epochs(res, 2), run_epochs(host, 2)
    (entry,) = res.train_engine._corpus.values()
    assert sorted(entry["local"]) == list(range(6)) and entry["mel"].shape[0] == 64
    assert entry["kind"] == ("f32" if model == "NISQA_DE" else "i16")
    assert ("mel_ref" in entry) == (model == "NISQA_DE")
    assert host.train_engine._corpus is None
    assert_epochs_close(out_res, out_host)
    sd_host = host.model.state_dict()
    for k, v in res.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd_host[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_resident_epoch_matches_jax(tmp_path_factory, monkeypatch):
    """The port's resident epoch against ``nisqa_tpu``'s resident
    ``run_epoch`` from the same initial weights: the corpus, lr 3e-5,
    unshuffled bs 4 and bounds of ``test_torch_train_epoch.py`` (loss 1e-4
    relative, train-mode and validation predictions 1e-3)."""
    tmp = tmp_path_factory.mktemp("torch_train_device_cache_jax")
    write_corpus(tmp)
    monkeypatch.setitem(EPOCH_ARGS, "tr_ds_to_memory", True)
    jr, pr = runners(tmp, "NISQA")
    jax_out, port_out, peng = run_both(jr, pr, 1)
    check_epoch(jax_out, port_out, 1)
    assert sorted(peng._corpus) == [16000, 48000] and peng.steps == 4
    assert all(e[0] == "meta" for e in peng._entries(pr.ds_train.paths()))


def test_warm_epoch_runs_no_host_fill_and_no_front_end(corpus, monkeypatch):
    """After the first epoch no train step decodes, fills or runs the
    DFT->mel step; every resident entry is a ('meta', n, sr) stub, and a
    resident row given to the host fill raises."""
    runner = make_runner(corpus, tr_ds_to_memory=True)
    engine = port_loop.TrainEngine(runner)
    dft_calls = []
    engine.dft_mel = lambda *a, **k: dft_calls.append(1) or dft_mel_reference(*a, **k)
    run_epochs(runner, 1, engine=engine)
    assert len(dft_calls) == 1  # the build: one 64-row chunk

    calls = []

    def spy(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    monkeypatch.setattr(InferenceEngine, "_make_batch", spy("make", InferenceEngine._make_batch))
    for name in ("fill_batch_i16", "fill_batch_f32"):
        monkeypatch.setattr(native, name, spy(name, getattr(native, name)))
    dft_calls.clear()
    (loss, y_hat), = run_epochs(runner, 1, engine=engine)
    assert calls == [] and dft_calls == []
    assert np.isfinite(loss) and np.isfinite(y_hat).all()
    paths = runner.ds_train.paths()
    entries = engine._entries(paths)
    assert [e[0] for e in entries] == ["meta"] * 6
    assert [e[1] for e in entries] == [SR] * 6
    with pytest.raises(RuntimeError, match="should be served from the mel corpus"):
        engine._batch([0], paths, None, entries, None, 3, "f32")


@pytest.mark.parametrize("cap_mb", [1e-4, 0])
def test_cap_leaves_the_host_fill(corpus, cap_mb, capfd):
    runner = make_runner(corpus, tr_ds_to_memory=True, tr_device_cache_mb=cap_mb)
    (loss, y_hat), = run_epochs(runner)
    assert runner.train_engine._corpus == {}
    assert np.isfinite(loss) and np.isfinite(y_hat).all()
    assert "0/6 rows device-resident" in capfd.readouterr().err


def test_over_long_file_raises_the_reference_error(corpus):
    runner = make_runner(corpus, "long.csv", tr_ds_to_memory=True)
    with pytest.raises(ValueError, match="ms_max_segments"):
        run_epochs(runner)


def test_partial_residency_matches_full(corpus, capfd):
    """80 equal files under a cap of 70 rows: the 64-row head stays
    resident, the advisory names the cap for full residency, the tail keeps
    its host entries, and an unshuffled epoch at bs 8 (no batch straddles)
    equals the fully resident one; a shuffled second epoch runs."""
    full = make_runner(corpus, "c80.csv", tr_ds_to_memory=True)
    part = make_runner(corpus, "c80.csv", tr_ds_to_memory=True,
                       tr_device_cache_mb=ROW_BYTES * 70 / (1 << 20))
    out_full = run_epochs(full, bs=8, shuffle=False)
    assert len(full.train_engine._corpus[SR]["local"]) == 80
    capfd.readouterr()
    out_part = run_epochs(part, bs=8, shuffle=False)
    err = capfd.readouterr().err
    assert "nisqa_tpu_torch: training corpus mels (sr 8000) exceed tr_device_cache_mb" in err
    assert "64/80 rows (longest files) stay device-resident" in err
    assert "tr_device_cache_mb >= " in err
    engine = part.train_engine
    entry = engine._corpus[SR]
    assert sorted(entry["local"]) == list(range(64)) and entry["mel"].shape[0] == 64
    entries = engine._entries(part.ds_train.paths())
    assert all(e[0] == "meta" for e in entries[:64])
    assert all(e[0] != "meta" for e in entries[64:])
    assert engine.history[-1]["steps"] == 10
    assert_epochs_close(out_part, out_full)
    loss, y_hat = engine.run_epoch(part.ds_train, port_loop._bias_losses(part, 1), 1e-3, 1, 8)
    assert np.isfinite(loss) and np.isfinite(y_hat).all() and engine.history[-1]["steps"] == 10


def test_partition_keeps_batches_whole(corpus):
    """72 rows, 64 resident, shuffled at bs 16: resident files first, so
    ceil(64/16) + ceil(8/16) = 5 steps (a plain shuffle would split nearly
    every batch in two)."""
    runner = make_runner(corpus, "c72.csv", tr_ds_to_memory=True,
                         tr_device_cache_mb=ROW_BYTES * 70 / (1 << 20))
    (loss, y_hat), = run_epochs(runner, bs=16)
    assert np.isfinite(loss) and np.isfinite(y_hat).all()
    assert runner.train_engine.history[-1]["steps"] == 5


def test_split_group_is_one_term_weighted_by_rows(corpus):
    """72 rows, 64 resident, unshuffled at bs 24: the third batch splits
    16 + 8, and the epoch loss is the mean of (l1, l2, (16 l3a + 8 l3b) /
    24), not nisqa_tpu's plain mean of the four steps."""
    runner = make_runner(corpus, "c72.csv", tr_ds_to_memory=True,
                         tr_device_cache_mb=ROW_BYTES * 70 / (1 << 20))
    (loss, _), = run_epochs(runner, bs=24, shuffle=False)
    terms = runner.train_engine.history[-1]["terms"]
    assert [[n for n, _ in t] for t in terms] == [[24], [24], [16, 8]]
    ((_, l1),), ((_, l2),), ((_, l3a), (_, l3b)) = terms
    assert loss == (l1 + l2 + (16 * l3a + 8 * l3b) / 24) / 3
    assert abs(loss - (l1 + l2 + l3a + l3b) / 4) > 1e-6


def test_tr_ds_to_memory_is_ported(corpus, capfd):
    """Only tr_parallel still prints a note."""
    port_loop.TrainEngine(make_runner(corpus, tr_ds_to_memory=True, tr_parallel=True))
    err = capfd.readouterr().err
    assert "tr_parallel: data parallelism is not ported" in err
    assert "tr_ds_to_memory" not in err
