"""The released NISQA-TTS model at its checkpoint geometry through the port,
held against the JAX package on the CPU.

The g3 golden's state dict (``nisqa_tts.tar``: StandardCNN + fc_out(20) ->
biLSTM(128) -> last_step_bi) is written as a ``.tar`` with the TTS front-end
(``ms_seg_hop_length`` 1, ``ms_fmax`` 8 kHz) and a small ``ms_max_segments``.
``predict_dir`` through ``NisqaTorch`` and ``NisqaTPU`` agree at "highest",
which both reach through the LSTM auto-upgrade (no ``precision`` arg); the
port's serving regimes (cold, cached, partial) agree with its cold pass.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from nisqa_tpu.audio.wav import write_wav
from nisqa_tpu.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu.compat.torch_ckpt import save_torch_checkpoint
from nisqa_tpu.model import NisqaTPU
from nisqa_tpu.models.nisqa import build_model as build_jax_model
from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from nisqa_tpu_torch.data import pipeline as pl
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from nisqa_tpu_torch.model import NisqaTorch
from tests.test_e2e import TINY_ARGS

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "g3_tts.npz")
TTS_GEOMETRY = {
    "ms_sr": None, "ms_fmax": 8000, "ms_n_fft": 4096, "ms_hop_length": 0.01,
    "ms_win_length": 0.02, "ms_n_mels": 48, "ms_seg_length": 15, "ms_seg_hop_length": 1,
    "ms_max_segments": 256, "ms_channel": None,
}


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    """(tar, wav paths): the g3 weights with the TTS geometry, and six
    seeded 48 kHz clips of 0.5-2 s."""
    tmp = tmp_path_factory.mktemp("torch_tts")
    z = np.load(GOLDEN, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    tar = str(tmp / "nisqa_tts.tar")
    args = {**meta["model_args"], **TTS_GEOMETRY, "model": "NISQA", "name": "NISQA_TTS"}
    torch.save({"args": args, "model_state_dict": sd, "model_name": "NISQA"}, tar)
    wavs = tmp / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(8)
    for i in range(6):
        n = int(48000 * float(np.exp(rng.uniform(np.log(0.5), np.log(2.0)))))
        t = np.arange(n) / 48000
        y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(n)
        write_wav(str(wavs / f"tts_{i}.wav"), y.astype(np.float32), 48000)
    return tar, sorted(str(p) for p in wavs.iterdir())


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_tts_predict_dir_matches_jax_at_highest(tts, tmp_path):
    tar, paths = tts
    out = {}
    for name, cls in (("jax", NisqaTPU), ("port", NisqaTorch)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        args = {"mode": "predict_dir", "pretrained_model": tar, "data_dir": os.path.dirname(paths[0]),
                "output_dir": str(out_dir), "tr_bs_val": 3, "tr_num_workers": 1}
        if cls is NisqaTorch:
            args["tr_device"] = "cpu"
        runner = cls(args)
        runner.predict()
        engine = runner._engine()
        # no precision arg: the LSTM model upgrades itself to "highest"
        assert "precision" not in runner.args or runner.args["precision"] is None
        assert engine.precision == "highest" and engine.fe_precision == "exact"
        out[name] = _read_csv(out_dir / "NISQA_results.csv")
    ref, got = out["jax"], out["port"]
    assert list(got[0]) == list(ref[0]) == ["deg", "mos_pred", "model"]
    assert [r["deg"] for r in got] == [r["deg"] for r in ref] == [os.path.basename(p) for p in paths]
    diff = max(abs(float(a["mos_pred"]) - float(b["mos_pred"])) for a, b in zip(got, ref))
    assert diff <= 1e-3


def _engine(tar, **kw):
    model, args = load_model_from_tar(tar)
    return InferenceEngine(model, MsConfig(args), "cpu", batch_size=2, num_workers=2, **kw)


def test_tts_geometry_buckets_and_consts(tts):
    tar, paths = tts
    eng = _engine(tar)
    ms = eng.ms
    assert ms.seg_hop == 1 and ms.buckets()[0] == 32 and ms.buckets()[-1] == 256
    assert ms.frames_for_bucket(256) == 270
    consts = pl.front_end_consts(ms, 48000, "i16")
    assert consts["w_re"].shape == (960, 768) and consts["fb_t"].shape == (768, 48)
    plan = eng.plan(paths)
    assert len(plan) == 3 and all(g[0] == 48000 and g[2] == "i16" for g, _ in plan)


@pytest.mark.parametrize("regime", ["cached", "partial"])
def test_tts_regimes_match_cold_pass(tts, regime):
    tar, paths = tts
    eng = _engine(tar, cache_mb=256)
    assert eng.precision == "highest" and eng.fe_precision == "exact"
    warmed = eng.warmup(paths)
    plan = eng.plan(paths)
    assert {g for s, g, _ in warmed if s == "cold"} == {g for g, _ in plan}
    y_cold = eng.predict_paths(paths)
    assert eng.stats["last"]["mode"] == "interleaved"
    # the cache holds each batch's (bs, frames_for_bucket, 48) float32 mels
    # and its int64 lengths
    entry = next(iter(eng._corpus_cache.values()))
    sizes = [pl._nbytes(db, n) for _, _, db, n in entry["batches"]]
    assert sizes == [2 * eng.ms.frames_for_bucket(g[1]) * 48 * 4 + 2 * 8 for g, _ in plan]
    if regime == "cached":
        y = eng.predict_paths(paths)
        assert eng.stats["last"]["mode"] == "cached"
    else:
        eng = _engine(tar, cache_mb=(sizes[0] + 1) / (1 << 20))
        eng.predict_paths(paths)
        y = eng.predict_paths(paths)
        assert eng.stats["last"]["mode"] == "cached_partial"
        assert eng.stats["last"]["resident_batches"] == 1
    assert np.isfinite(y).all() and y.shape == (len(paths), 1)
    np.testing.assert_allclose(y, y_cold, atol=1e-6)


def _tiny_ckpt(tmp, name, extra):
    args = {**TINY_ARGS, **extra, "name": name}
    args.pop("precision", None)
    model = build_jax_model("NISQA", model_args_from_ckpt_args(args))
    params, state = model.init(jax.random.PRNGKey(2))
    path = str(tmp / f"{name}.tar")
    save_torch_checkpoint(path, model, params, state, args)
    return path


@pytest.mark.parametrize("td,expected", [("lstm", "highest"), ("self_att", "default")])
def test_precision_default_follows_the_model(tmp_path, td, expected):
    """No ``precision`` arg: an LSTM checkpoint serves at "highest" and a
    self-attention one at "default", in both packages (the engine decides)."""
    extra = {"td": "lstm", "td_lstm_h": 8, "td_lstm_num_layers": 1,
             "td_lstm_bidirectional": True} if td == "lstm" else {}
    ckpt = _tiny_ckpt(tmp_path, f"tiny_{td}", extra)
    (tmp_path / "a.wav").write_bytes(b"")
    args = {"mode": "predict_dir", "pretrained_model": ckpt, "data_dir": str(tmp_path)}
    jax_engine = NisqaTPU(dict(args))._engine()
    port_engine = NisqaTorch({**args, "tr_device": "cpu"})._engine()
    assert jax_engine.precision == port_engine.precision == expected
    assert jax_engine.fe_precision == port_engine.fe_precision == (
        "exact" if expected == "highest" else "fast")
    model, margs = load_model_from_tar(ckpt)
    for precision, want in ((None, expected), ("default", expected), ("highest", "highest")):
        assert InferenceEngine(model, MsConfig(margs), "cpu", precision=precision).precision == want
