"""The port's measurement tools (``nisqa_tpu_torch.tools``) on the CPU.

* The corpus recipes write the bytes of the JAX tools' recipes
  (``bench.py``, ``tools/bench_tts.py``, ``tools/bench_de.py``,
  ``tools/bench_train.py``), imported only inside the tests.
* ``tools.flops`` equals the closed form of the released NISQA_DIM at the
  yaml geometry exactly (AdaptCNN and front-end), and
  ``torch.utils.flop_counter.FlopCounterMode`` over the port's models
  exactly, for every product that mode sees. It does not see two: the
  masked LSTM's gate products (``aten.lstm`` reaches it as one op with no
  formula), held here by FlopCounterMode over the same products written
  out step by step; and the bahd scorer's product with ``v`` (a
  matrix-vector product, ``aten.mv``, which it does not count), held by
  its closed form alone.
* Against the JAX package's ``tools/flops.py`` (XLA's cost model): the cold
  extra within 0.5%; the cached pass lower by XLA by the padding-tap
  convention (XLA counts a convolution's taps on real input only), the
  ratio XLA / port in [0.80, 0.90].
* Each tool's ``main`` at a tiny size with ``--device cpu`` prints one JSON
  record; without ``--device cpu`` a tool exits non-zero when there is no
  card.
"""

import filecmp
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from nisqa_tpu_torch.audio.wav import read_wav, write_wav
from nisqa_tpu_torch.compat.checkpoint import build_from_args, load_model_from_tar
from nisqa_tpu_torch.models.td import LSTM
from nisqa_tpu_torch.tools import bench, bench_de, bench_train, bench_tts, corpus, flops
from tests.test_e2e import TINY_ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# NISQA_DIM's AdaptCNN on one 48 x 15 segment: convs 1->16, 16->32 at 24x7,
# 32->64 and 64->64 at 12x5, 64->64 at 6x3, 64->64 with a (3, 3) kernel
# collapsing 6x3 to 6x1; 2 FLOPs per tap, padding taps included
ADAPT_CNN_PER_SEGMENT = 2 * 9 * (48 * 15 * 16 * 1 + 24 * 7 * 32 * 16 + 12 * 5 * 64 * 32
                                 + 12 * 5 * 64 * 64 + 6 * 3 * 64 * 64 + 6 * 1 * 64 * 64)
TINY_GEOMETRY = {**corpus.YAML_GEOMETRY, "ms_fmax": 4000.0, "ms_n_mels": 24, "ms_seg_length": 7}
TINY_DE = {"model": "NISQA_DE", "td_2": "self_att", "td_2_sa_d_model": 16, "td_2_sa_nhead": 1,
           "td_2_sa_pos_enc": False, "td_2_sa_num_layers": 1, "td_2_sa_h": 16,
           "td_2_sa_dropout": 0.1, "de_align": "cosine", "de_align_apply": "hard",
           "de_fuse": "x/y/-", "de_fuse_dim": None}
TINY_TTS = {**corpus.TTS_GEOMETRY, "ms_fmax": 4000.0, "model": "NISQA", "cnn_model": "standard",
            "cnn_fc_out_h": 8, "td": "lstm", "td_lstm_h": 8, "td_lstm_num_layers": 1,
            "td_lstm_dropout": 0, "td_lstm_bidirectional": True, "pool": "last_step_bi",
            "pool_att_h": None}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """A JAX-side tool module, imported from its file."""
    path = os.path.join(REPO, name if name == "bench.py" else os.path.join("tools", name))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _save(path, args, seed):
    torch.manual_seed(seed)
    model = build_from_args(args)
    torch.save({"args": args, "model_state_dict": model.state_dict(), "model_name": args["model"]},
               path)
    return str(path)


def _same_files(a, b):
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for p, q in zip(a, b):
        assert filecmp.cmp(p, q, shallow=False), (p, q)


# -- (a) the corpora ---------------------------------------------------------


def test_bench_corpus_bytes_match_bench_py(tmp_path):
    total_j, paths_j = _jax_tool("bench.py").make_corpus(str(tmp_path / "jax"), n_files=3)
    total, paths = corpus.bench_corpus(str(tmp_path / "port"), 3)
    assert total == total_j
    _same_files(paths, paths_j)
    # a corpus completed over two runs holds one run's bytes, and no temporary file stays
    os.remove(paths[1])
    assert corpus.bench_corpus(str(tmp_path / "port"), 3) == (total, paths)
    _same_files(paths, paths_j)
    assert sorted(os.listdir(tmp_path / "port")) == [os.path.basename(p) for p in paths]


def test_tts_corpus_bytes_match_bench_tts(tmp_path):
    total_j, paths_j = _jax_tool("bench_tts.py").make_corpus(str(tmp_path / "jax"), n_files=3)
    total, paths = corpus.tts_corpus(str(tmp_path / "port"), 3)
    assert total == total_j
    _same_files(paths, paths_j)


def test_de_corpus_bytes_match_bench_de(tmp_path):
    audio_j, deg_j, ref_j, mos_j = _jax_tool("bench_de.py").make_de_corpus(
        str(tmp_path / "jax"), n_pairs=3)
    audio, deg, ref, mos = corpus.de_corpus(str(tmp_path / "port"), 3)
    assert audio == audio_j
    np.testing.assert_array_equal(mos, mos_j)
    _same_files(deg, deg_j)
    _same_files(ref, ref_j)


def test_portable_de_corpus_moves_only_the_noise_scale(tmp_path):
    """``portable`` takes the mean powers exactly rounded: the same reference
    files and MOS, degraded samples within one 16-bit step, and the noise at
    the drawn SNR."""
    _, deg, ref, mos = corpus.de_corpus(str(tmp_path / "float32"), 3)
    _, deg_p, ref_p, mos_p = corpus.de_corpus(str(tmp_path / "portable"), 3, portable=True)
    _same_files(ref, ref_p)
    np.testing.assert_array_equal(mos, mos_p)
    for d, dp, r, m in zip(deg, deg_p, ref_p, mos_p):
        (y, _), (yp, _), (yr, _) = (read_wav(p) for p in (d, dp, r))
        assert np.abs(yp - y).max() <= 1.0 / 32768 + 1e-9
        noise = yp.astype(np.float64) - yr
        snr = 10 * np.log10(np.mean(np.square(yr, dtype=np.float64)) / np.mean(noise ** 2))
        assert abs(1.0 + 4.0 * snr / 40.0 - m) < 0.02


def test_learnable_mos_matches_bench_train(tmp_path):
    _, paths = corpus.bench_corpus(str(tmp_path), 3)
    np.testing.assert_array_equal(corpus.learnable_mos(paths),
                                  _jax_tool("bench_train.py")._learnable_mos(paths))


# -- (b)-(e) the FLOP counter ---------------------------------------------------


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The released NISQA_DIM at the yaml geometry and 2 files of 3 s and 5 s
    at 48 kHz: one batch of 2 at bucket 163."""
    tmp = tmp_path_factory.mktemp("flops_probe")
    wavs = tmp / "wavs"
    wavs.mkdir()
    for i, seconds in enumerate((3.0, 5.0)):
        t = np.arange(int(48000 * seconds)) / 48000
        write_wav(str(wavs / f"p{i}.wav"), (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32),
                  48000)
    tar = corpus.golden_tar("g2_dim", corpus.YAML_GEOMETRY, str(tmp / "dim.tar"))
    return tar, str(wavs), flops.count_flops(tar, str(wavs), 2)


def test_flops_equal_the_closed_form(probe):
    _, _, rec = probe
    assert rec["plan_batches"] == 1 and rec["n_files"] == 2 and rec["total_audio_s"] == 8.0
    # 2 rows x bucket 163 segments
    assert rec["cached_by_part"]["framewise"] == ADAPT_CNN_PER_SEGMENT * 326 == 3_312_368_640
    # 2 rows x 663 frames of the bucket, span 960, K 1,792 kept bins, 48 mels
    n = 2 * ((163 - 1) * 4 + 15)
    assert rec["cold_flops_per_pass"] - rec["cached_flops_per_pass"] == (
        4 * n * 960 * 1792 + 2 * n * 1792 * 48) == flops.front_end_flops(n, 960, 1792, 48)
    assert rec["cached_flops_per_pass"] == sum(rec["cached_by_part"].values())


def _counted(fn):
    with torch.inference_mode(), FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def _narrow_tts(tmp_path):
    return load_model_from_tar(_save(tmp_path / "tts.tar", {**TINY_ARGS, **TINY_TTS}, 3))[0]


def _golden_model(tmp_path, name):
    if name == "g3_tts_narrow":
        return _narrow_tts(tmp_path)
    return load_model_from_tar(corpus.golden_tar(name, corpus.YAML_GEOMETRY,
                                                 str(tmp_path / "m.tar")))[0]


@pytest.mark.parametrize("name", ["g2_dim", "g3_tts_narrow", "g5_double_ended", "g4_cnn_lstm_avg",
                                  "g6_dff_poolatt", "g7_skip_max", "g8_lstm2_laststep",
                                  "g10_posenc"])
def test_flops_equal_flop_counter_mode(tmp_path, name):
    """Every framewise, time-dependency and pooling kind of the goldens (and
    a narrow NISQA-TTS); the LSTM stages are the closed form's alone."""
    model = _golden_model(tmp_path, name)
    rows, t = 3, 40
    x, n = torch.randn(rows, t, 48, 15), torch.tensor([t, t - 7, 9])
    parts = flops.forward_flops(model, rows, t, 48, 15)
    if model.double_ended:
        seen = _counted(lambda: model.forward_ends(x, n, x.flip(1), n.flip(0)))
    else:
        seen = _counted(lambda: model(x, n))
    unseen = sum(parts[k] for k, td in (("td", model.time_dependency),
                                        ("td_2", model.time_dependency_2))
                 if isinstance(td.model, LSTM))  # test below
    assert seen == sum(parts.values()) - unseen
    assert seen > 0 and all(v >= 0 for v in parts.values())


@pytest.mark.parametrize("name", ["g3_tts_narrow", "g8_lstm2_laststep"])
def test_lstm_closed_form_equals_its_products_step_by_step(tmp_path, name):
    """The masked LSTM's gates (bidirectional: each direction over 2 x rows
    rows, the bucket and its right-aligned copy; two layers, one way) at
    every step of the bucket, as the products x_t W_ih^T + h W_hh^T written
    out."""
    lstm = _golden_model(tmp_path, name).time_dependency.model.lstm
    rows, t = 3, 12

    def steps():
        for layer in lstm.layers:
            run_rows = 2 * rows if layer.bidirectional else rows
            x = torch.randn(run_rows, t, layer.input_size)
            for sfx in ("", "_reverse")[: 2 if layer.bidirectional else 1]:
                h = torch.zeros(run_rows, layer.hidden_size)
                c = torch.zeros_like(h)
                for s in range(t):
                    g = (F.linear(x[:, s], getattr(layer, "weight_ih_l0" + sfx),
                                  getattr(layer, "bias_ih_l0" + sfx))
                         + F.linear(h, getattr(layer, "weight_hh_l0" + sfx),
                                    getattr(layer, "bias_hh_l0" + sfx)))
                    i, f, gg, o = g.chunk(4, 1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
                    h = torch.sigmoid(o) * torch.tanh(c)

    assert flops.lstm_flops(rows, t, lstm) == _counted(steps) > 0


@pytest.mark.parametrize("scorer", ["dot", "cosine", "distance", "bahd", "luong"])
@pytest.mark.parametrize("apply", ["hard", "soft"])
def test_alignment_flops_equal_flop_counter_mode(tmp_path, scorer, apply):
    """Every scorer x apply of a narrow NISQA_DE with a fusion projection;
    the bahd scorer's product with v (aten.mv) is the closed form's alone."""
    args = {**TINY_ARGS, **TINY_GEOMETRY, **TINY_DE, "de_align": scorer, "de_align_apply": apply,
            "de_fuse_dim": 12}
    model = load_model_from_tar(_save(tmp_path / "de.tar", args, 5))[0]
    rows, t = 2, 30
    x, n = torch.randn(rows, t, 24, 7), torch.tensor([t, 17])
    parts = flops.forward_flops(model, rows, t, 24, 7)
    seen = _counted(lambda: model.forward_ends(x, n, -x, n))
    unseen = 2 * rows * t * t * model.align.att["Wq"].out_features if scorer == "bahd" else 0
    assert seen == sum(parts.values()) - unseen
    assert parts["fusion"] == 2 * rows * t * 3 * 16 * 12


def test_flops_against_the_jax_tool(probe):
    tar, wavs, rec = probe
    xla = _jax_tool("flops.py").count_flops(tar, wavs, 2)
    extra, extra_xla = (r["cold_flops_per_pass"] - r["cached_flops_per_pass"] for r in (rec, xla))
    assert abs(extra_xla - extra) <= 0.005 * extra
    assert 0.80 <= xla["cached_flops_per_pass"] / rec["cached_flops_per_pass"] <= 0.90
    assert (xla["n_files"], xla["plan_batches"], xla["total_audio_s"]) == (
        rec["n_files"], rec["plan_batches"], rec["total_audio_s"])


def test_flops_cli_on_a_double_ended_tar(tmp_path, capsys):
    corpus.de_corpus(str(tmp_path), 3)
    tar = os.path.join(corpus.GOLDENS, "de_trained.tar")
    rec = flops.main([tar, str(tmp_path), "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["n_files"] == 3 and rec["plan_batches"] == 2 and rec["total_audio_s"] == 24.0
    assert all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
        "cached_flops_per_pass", "cold_flops_per_pass", "flops_per_audio_s_cached"))
    assert rec["cached_by_part"]["align"] > 0
    # both ends front-ended: 2 batches x 2 ends at the 8 s files' bucket
    ms = load_model_from_tar(tar)[1]
    from nisqa_tpu_torch.data.pipeline import MsConfig

    ms = MsConfig(ms)
    bucket = ms.bucket_for(ms.n_wins(ms.n_frames(8 * 48000, 48000)))
    assert rec["cold_flops_per_pass"] - rec["cached_flops_per_pass"] == (
        4 * flops.batch_front_end_flops(ms, 48000, bucket, 2))


# -- (f) the tools at a tiny size ----------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY_ARGS checkpoints at a 48 kHz front-end, and the shared bench corpus."""
    tmp = tmp_path_factory.mktemp("tools_tiny")
    base = {**TINY_ARGS, **TINY_GEOMETRY}
    tars = {
        "dim": _save(tmp / "dim.tar", {**base, "model": "NISQA_DIM"}, 1),
        "nisqa": _save(tmp / "nisqa.tar", {**base, "model": "NISQA"}, 2),
        "tts": _save(tmp / "tts.tar", {**TINY_ARGS, **TINY_TTS}, 3),
        "de": _save(tmp / "de.tar", {**base, **TINY_DE}, 4),
    }
    bench_dir = str(tmp / "bench")
    corpus.bench_corpus(bench_dir, 12)
    return tmp, tars, bench_dir


SERVING_KEYS = ("value", "cold_pass_rate", "fetched_best_pass", "fetched_cached_median",
                "flops_per_audio_s", "tflops_sustained", "peak_tflops", "mfu_pct",
                "cached_flops_per_pass", "cold_flops_per_pass", "total_audio_s")


def _record(capsys, rec):
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(rec))
    return rec


def _serving_checks(rec, keys):
    for k in keys:
        assert isinstance(rec[k], (int, float)) and math.isfinite(rec[k]), (k, rec[k])
    assert 0 < rec["mfu_pct"] <= 100
    assert rec["cached_max_abs_diff"] <= 1e-6
    assert rec["device"] == "cpu" and rec["idle_cached_pass"] is None


def test_bench_main(tiny, capsys):
    tmp, tars, bench_dir = tiny
    rec = _record(capsys, bench.main([
        "--device", "cpu", "--files", "3", "--bs", "2", "--tar", tars["dim"],
        "--corpus-dir", bench_dir, "--passes", "3", "--devrate-passes", "2",
        "--async-blocks", "2", "--async-depth", "2"]))
    _serving_checks(rec, SERVING_KEYS + (
        "async_best_pass", "async_median", "devrate_best_pass", "devrate_median",
        "mfu_devrate_pct"))
    assert rec["metric"] == "predict_dir_throughput_nisqa_dim_bs2_async_pipelined"
    assert (rec["fetched_cached_n"], rec["devrate_n"], rec["async_n"]) == (2, 2, 2)
    assert rec["value"] == rec["async_best_pass"] and rec["peak_tflops"] == 494.7
    assert rec["plan_batches"] == 2 and rec["n_files"] == 3


def test_bench_devrate_main(tiny, capsys):
    tmp, tars, bench_dir = tiny
    rec = _record(capsys, bench.main([
        "--device", "cpu", "--files", "3", "--bs", "2", "--tar", tars["dim"],
        "--corpus-dir", bench_dir, "--passes", "3", "--devrate", "--precision", "highest",
        "--no-fuse", "--fe", "fast"]))
    assert rec["metric"].endswith("_devrate_nofetch") and rec["devrate_n"] == 2
    assert rec["value"] == rec["devrate_best_pass"] and rec["peak_tflops"] == 66.9
    assert (rec["precision"], rec["fe_precision"]) == ("highest", "fast")
    assert 0 < rec["mfu_pct"] <= 100 and "async_n" not in rec


def test_bench_tts_main(tiny, capsys):
    tmp, tars, _ = tiny
    rec = _record(capsys, bench_tts.main([
        "--device", "cpu", "--files", "2", "--bs", "2", "--passes", "3", "--tar", tars["tts"],
        "--corpus-dir", str(tmp / "tts")]))
    _serving_checks(rec, SERVING_KEYS)
    assert rec["precision"] == "highest" and rec["peak_tflops"] == 66.9  # the LSTM's upgrade
    assert rec["value"] == rec["fetched_best_pass"] and rec["fetched_cached_n"] == 2


def test_bench_de_main(tiny, capsys):
    tmp, tars, _ = tiny
    rec = _record(capsys, bench_de.main([
        "--device", "cpu", "--pairs", "3", "--bs", "2", "--tar", tars["de"],
        "--corpus-dir", str(tmp / "de"), "--passes", "2", "--devrate-passes", "1",
        "--async-blocks", "1", "--async-depth", "2"]))
    _serving_checks(rec, SERVING_KEYS + ("async_best_pass", "devrate_best_pass", "fetched_median"))
    assert rec["n_pairs"] == 3 and rec["total_audio_s"] == 24.0 and rec["plan_batches"] == 2


def test_bench_train_main(tiny, capsys):
    tmp, tars, bench_dir = tiny
    rec = _record(capsys, bench_train.main([
        "--device", "cpu", "--files", "12", "--epochs", "2", "--bs", "4", "--learnable",
        "--arch-tar", tars["nisqa"], "--corpus-dir", bench_dir]))
    for k in ("value", "epoch_sec_best", "train_audio_s", "full_loop_sec_2ep", "final_val_r_p",
              "final_val_rmse_map", "corpus_build_s"):
        assert isinstance(rec[k], float) and math.isfinite(rec[k]), (k, rec[k])
    assert rec["metric"] == "train_epoch_throughput_nisqa_bs4" and len(rec["epoch_sec"]) == 2
    assert rec["value"] == rec["train_audio_s"] / rec["epoch_sec"][1]
    assert rec["steps_per_epoch"] == 3 and rec["files"] == 12
    assert rec["idle_warm_epoch"] is None and rec["launches"] == 0 and rec["device"] == "cpu"
    assert "mfu_pct" not in rec and "vs_baseline" not in rec


# -- (g) no card, no run ---------------------------------------------------------------


TOOLS = ("bench", "bench_tts", "bench_de", "bench_train", "parity")


@pytest.fixture(scope="module")
def without_card(tmp_path_factory):
    """Each bench tool run with its defaults (CUDA) in its own process, all
    started together: {tool: (exit code, stderr, corpus folder)}."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    tmp = tmp_path_factory.mktemp("no_card")
    procs = {t: subprocess.Popen(
        [sys.executable, "-m", f"nisqa_tpu_torch.tools.{t}", "--corpus-dir", str(tmp / t)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for t in TOOLS}
    out = {}
    for t, p in procs.items():
        try:
            err = p.communicate(timeout=120)[1]
        finally:
            p.kill()
        out[t] = (p.returncode, err, tmp / t)
    return out


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_a_card_exits_nonzero(without_card, tool):
    rc, err, corpus_dir = without_card[tool]
    assert rc != 0
    assert "needs CUDA" in err
    assert not os.path.exists(corpus_dir)  # it stopped before any work
