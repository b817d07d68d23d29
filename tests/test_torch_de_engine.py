"""Double-ended serving through the port's engine and CLI, on the CPU.

A tiny NISQA_DE checkpoint over eight pairs (8 kHz PCM16 pairs of unequal
lengths, one pair whose reference is a float32 WAV and so takes the f32
transport, one 16 kHz pair): the cold pass runs two mel stages per batch and
is within 1e-3 of ``nisqa_tpu``'s engine at "highest"; every serving regime
(warmup, cached fused, per batch and in parts, async, partial residency) is
within 1e-6 of it. Then the full-width ``tests/goldens/de_trained.tar`` at
its 48 kHz yaml geometry through ``predict_csv`` against
``NisqaTPU.predict``, and the errors of a malformed call.
"""

import os

import numpy as np
import pandas as pd
import pytest

from nisqa_tpu.audio.wav import write_wav
from nisqa_tpu.compat.torch_ckpt import load_model_from_tar as load_jax_model
from nisqa_tpu.data.pipeline import InferenceEngine as JaxEngine, MsConfig as JaxMsConfig
from nisqa_tpu_torch.compat.checkpoint import load_model_from_tar
from nisqa_tpu_torch.data import pipeline as pl
from nisqa_tpu_torch.data.pipeline import InferenceEngine, MsConfig
from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference
from tests.test_e2e import _write_corpus
from tests.test_e2e_de_eval import _make_de_ckpt
from tests.test_torch_host import _wav_bytes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(checkpoint, degraded paths, reference paths): 6 PCM16 pairs at
    8 kHz, one at 8 kHz with a float32 reference, one at 16 kHz."""
    tmp = tmp_path_factory.mktemp("torch_de_engine")
    ckpt = _make_de_ckpt(tmp)
    names = [str(tmp / n) for n in _write_corpus(tmp, n=12)]
    deg, ref = names[:6], names[6:]
    rng = np.random.default_rng(1)
    t = np.arange(6000) / 8000
    y = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t))).astype("<f4")
    (tmp / "ref_f32.wav").write_bytes(_wav_bytes(y.tobytes(), 3, 1, 8000, 32))
    deg.append(names[7])
    ref.append(str(tmp / "ref_f32.wav"))
    sub = tmp / "16k"
    sub.mkdir()
    wide = [str(sub / n) for n in _write_corpus(sub, n=2, sr=16000)]
    return ckpt, deg + wide[:1], ref + wide[1:]


def _engine(ckpt, **kw):
    model, args = load_model_from_tar(ckpt)
    kw.setdefault("precision", "highest")
    return InferenceEngine(model, MsConfig(args), "cpu", num_workers=2, **kw)


def _counting(calls):
    def dft_mel(*a, **kw):
        calls.append(a[0].shape)
        return dft_mel_reference(*a, **kw)
    return dft_mel


@pytest.fixture(scope="module")
def cold(pairs):
    """The port's cold pass at bs 3 and its plan, with the mel stage's
    calls counted."""
    ckpt, deg, ref = pairs
    calls = []
    eng = _engine(ckpt, batch_size=3, cache_mb=0, dft_mel=_counting(calls))
    y = eng.predict_paths(deg, ref)
    return y, eng.plan(deg, ref), calls


def test_cold_pass_matches_jax_engine(pairs, cold):
    ckpt, deg, ref = pairs
    y, plan, calls = cold
    # (sr, transport) groups: 8 kHz i16 (6 pairs: 2 batches), 8 kHz f32, 16 kHz i16
    assert sorted((g[0], g[2], len(c)) for g, c in plan) == \
        [(8000, "f32", 1), (8000, "i16", 3), (8000, "i16", 3), (16000, "i16", 1)]
    assert len(calls) == 2 * len(plan)  # one mel stage per end and batch
    jmodel, params, state, args = load_jax_model(ckpt)
    y_jax = JaxEngine(jmodel, params, state, JaxMsConfig(args), batch_size=3, num_workers=1,
                      precision="highest", fe_precision="exact",
                      cache_mb=0).predict_paths(deg, ref)
    assert y.shape == y_jax.shape == (8, 1) and np.isfinite(y).all()
    assert np.abs(y - y_jax).max() <= 1e-3


def test_every_regime_equals_the_cold_pass(pairs, cold, monkeypatch):
    ckpt, deg, ref = pairs
    y_cold, plan, _ = cold

    def close(y):
        assert np.abs(y - y_cold).max() <= 1e-6

    eng = _engine(ckpt, batch_size=3, cache_mb=64)
    warmed = eng.warmup(deg, ref)
    assert {g for s, g, _ in warmed if s == "cold"} == {g for g, _ in plan}
    assert {g for s, g, _ in warmed if s == "seg"} == {g for g, _ in plan}
    assert sorted(eng._rings, key=str) == [("f32", "ref"), ("i16", "ref"), "f32", "i16"]
    close(eng.predict_paths(deg, ref))
    assert eng.stats["last"]["mode"] == "interleaved"
    entry = next(iter(eng._corpus_cache.values()))
    assert entry["mode"] == "mel" and all(len(b) == 6 for b in entry["batches"])
    close(eng.predict_paths(deg, ref))
    entry = next(iter(eng._corpus_cache.values()))
    assert eng.stats["last"]["mode"] == "cached" and entry["mode"] == "mel_fused"
    assert entry["flat"].shape[0] == 2 and entry["ns"].shape == (2, 3 * len(plan))
    handles = [eng.predict_paths(deg, ref, fetch="async") for _ in range(2)]
    for h in handles:
        close(h())
    assert eng.stats["passes"] == 4 and eng.stats["cache_hits"] == 3

    per_batch = _engine(ckpt, batch_size=3, cache_mb=64, fuse_pass=False)
    per_batch.predict_paths(deg, ref)
    close(per_batch.predict_paths(deg, ref))
    assert next(iter(per_batch._corpus_cache.values()))["mode"] == "mel"

    # one pair per batch: consecutive batches of one shape fuse into parts
    # of two batches, as views of the flat block and as concatenated parts
    for fuse_whole_max, mode in ((pl.FUSE_WHOLE_MAX, "mel_fused"), (1, "mel_fused_parts")):
        monkeypatch.setattr(pl, "FUSE_WHOLE_MAX", fuse_whole_max)
        ones = _engine(ckpt, batch_size=1, cache_mb=64)
        close(ones.predict_paths(deg, ref))
        close(ones.predict_paths(deg, ref))
        entry = next(iter(ones._corpus_cache.values()))
        assert entry["mode"] == mode and all(len(p) == 5 for p in entry["parts"])
        assert sorted(p[1].shape[0] for p in entry["parts"]) == [1, 1, 1, 1, 2, 2]
        assert all(p[1].shape == p[3].shape for p in entry["parts"])

    # about half the blocks resident: the cold tail re-scans both ends
    full = sum(pl._nbytes(*b[2:]) for b in
               next(iter(per_batch._corpus_cache.values()))["batches"])
    calls = []
    partial = _engine(ckpt, batch_size=3, cache_mb=full / 2 / (1 << 20),
                      dft_mel=_counting(calls))
    close(partial.predict_paths(deg, ref))
    calls.clear()
    close(partial.predict_paths(deg, ref))
    last = partial.stats["last"]
    assert last["mode"] == "cached_partial" and last["resident_batches"] > 0
    assert last["cold_batches"] > 0 and len(calls) == 2 * last["cold_batches"]


def test_malformed_calls_raise(pairs, tmp_path):
    ckpt, deg, ref = pairs
    eng = _engine(ckpt, batch_size=3, cache_mb=0)
    for call in (eng.predict_paths, eng.plan, eng.warmup):
        with pytest.raises(ValueError, match="needs paths_ref"):
            call(deg)
        with pytest.raises(ValueError, match="2 files for 3 degraded"):
            call(deg[:3], ref[:2])
    # an 8 kHz degraded file against a 16 kHz reference
    with pytest.raises(ValueError, match="sample rates differ"):
        eng.predict_paths(deg[:1], ref[-1:])


def _write_pairs(out_dir, n, sr=48000, seed=0):
    """``tools/bench_de.py``'s pairs, 2-4 s: a multi-harmonic reference
    and the degraded end with white noise at 0-40 dB SNR, up to 0.5 s
    shorter. Returns (degraded names, reference names)."""
    rng = np.random.default_rng(seed)
    deg, ref = [], []
    for i in range(n):
        t = np.arange(int(sr * rng.uniform(2.0, 4.0))) / sr
        f0 = rng.uniform(100, 300)
        y = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2.05 * f0 * t)
             + 0.05 * np.sin(2 * np.pi * 3.1 * f0 * t)).astype(np.float32)
        noise = rng.standard_normal(len(t)).astype(np.float32)
        noise *= np.sqrt((y ** 2).mean() / 10 ** (rng.uniform(0, 40) / 10) / (noise ** 2).mean())
        cut = len(t) - int(sr * rng.uniform(0, 0.5))
        write_wav(os.path.join(out_dir, f"ref_{i}.wav"), y, sr)
        write_wav(os.path.join(out_dir, f"deg_{i}.wav"), np.clip(y + noise, -0.999, 0.999)[:cut], sr)
        deg.append(f"deg_{i}.wav")
        ref.append(f"ref_{i}.wav")
    return deg, ref


def test_de_trained_predict_csv_matches_nisqa_tpu(tmp_path):
    """The full-width trained DE checkpoint through the port's
    ``predict_csv`` (the reference column from the checkpoint's
    ``csv_ref``) and through ``NisqaTPU``, both at "highest": same columns
    and row order, predictions within 1e-3. The port's CLI at its default
    precision (bf16 DFT operands, which ``nisqa_tpu`` does not round to on
    the CPU) writes the same table within 0.02 MOS mean absolute error, the
    default-precision DE bound of ROADMAP Queue 3."""
    from nisqa_tpu.model import NisqaTPU
    from nisqa_tpu_torch import load_predictor, run_predict
    from nisqa_tpu_torch.model import NisqaTorch

    deg, ref = _write_pairs(str(tmp_path), 5)
    order = [3, 0, 4, 1, 2]
    pd.DataFrame({"deg": [deg[i] for i in order], "ref": [ref[i] for i in order],
                  "mos": np.linspace(1, 5, 5)}).to_csv(tmp_path / "pairs.csv", index=False)
    tar = os.path.join(GOLDEN_DIR, "de_trained.tar")
    outs = {k: tmp_path / f"out_{k}" for k in ("torch", "jax", "cli")}
    for out in outs.values():
        out.mkdir()
    args = {"mode": "predict_csv", "pretrained_model": tar, "csv_file": "pairs.csv",
            "csv_deg": "deg", "data_dir": str(tmp_path), "tr_bs_val": 4, "tr_num_workers": 0,
            "precision": "highest"}
    NisqaTorch({**args, "output_dir": str(outs["torch"]), "tr_device": "cpu"}).predict()
    NisqaTPU({**args, "output_dir": str(outs["jax"])}).predict()
    runner = run_predict.main(["--mode", "predict_csv", "--pretrained_model", tar, "--csv_file",
                               "pairs.csv", "--csv_deg", "deg", "--data_dir", str(tmp_path),
                               "--bs", "4", "--output_dir", str(outs["cli"]),
                               "--tr_device", "cpu"])
    assert runner.engine.precision == "default"
    got, want, cli = (pd.read_csv(outs[k] / "NISQA_results.csv") for k in ("torch", "jax", "cli"))
    assert list(got.columns) == list(want.columns) == list(cli.columns) == \
        ["deg", "ref", "mos", "mos_pred", "model"]
    for col in ("deg", "ref", "model"):
        assert list(got[col]) == list(want[col]) == list(cli[col])
    y_want = want["mos_pred"].to_numpy()
    assert np.isfinite(got["mos_pred"]).all()
    assert np.abs(got["mos_pred"].to_numpy() - y_want).max() <= 1e-3
    assert np.abs(cli["mos_pred"].to_numpy() - y_want).mean() <= 0.02

    # the one-call API over the same pairs
    predict = load_predictor(tar, batch_size=4, tr_device="cpu", precision="highest", cache_mb=0)
    y = predict([str(tmp_path / d) for d in got["deg"]], [str(tmp_path / r) for r in got["ref"]])
    assert np.abs(y[:, 0] - y_want).max() <= 1e-3


@pytest.mark.parametrize("mode", ["predict_file", "predict_dir"])
def test_de_without_reference_column_raises(tmp_path, mode):
    from nisqa_tpu_torch.model import NisqaTorch

    deg, _ = _write_pairs(str(tmp_path), 1)
    with pytest.raises(ValueError, match="no reference column"):
        NisqaTorch({"mode": mode, "pretrained_model": os.path.join(GOLDEN_DIR, "de_trained.tar"),
                    "deg": str(tmp_path / deg[0]), "data_dir": str(tmp_path),
                    "tr_device": "cpu"})
