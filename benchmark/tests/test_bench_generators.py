"""The seeded generators: corpus lengths and samples, request arrivals."""

import numpy as np
import pytest
import torch

from benchmark import corpus
from benchmark.drivers.open_loop import schedule


@pytest.mark.parametrize("dist,lo,hi", [("log_uniform", 3.0, 30.0), ("uniform", 6.0, 12.0)])
def test_lengths_are_the_same_set_in_a_seeded_order(dist, lo, hi):
    a = corpus.lengths(384, lo, hi, dist, 48000, 2 ** 31 + 5)
    b = corpus.lengths(384, lo, hi, dist, 48000, 2 ** 31 + 5)
    c = corpus.lengths(384, lo, hi, dist, 48000, 7)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and np.array_equal(np.sort(a), np.sort(c))
    sec = np.sort(a) / 48000
    assert lo <= sec[0] and sec[-1] <= hi
    mid = np.sqrt(lo * hi) if dist == "log_uniform" else (lo + hi) / 2
    assert abs(np.median(sec) - mid) < 0.02 * mid


def test_the_bench_corpus_is_about_4500_audio_seconds():
    n = corpus.lengths(384, 3.0, 30.0, "log_uniform", 48000, 1)
    assert 4400 < n.sum() / 48000 < 4800


def test_samples_repeat_by_seed_and_read_back(tmp_path):
    from nisqa_tpu_torch.audio.wav import read_wav

    n = np.array([48000 * 3, 48000 * 4 + 17])
    a = corpus.synth(n, 48000, 11, "cpu")
    b = corpus.synth(n, 48000, 11, "cpu")
    c = corpus.synth(n, 48000, 12, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert [len(x) for x in a] == n.tolist() and a[0].dtype == np.int16
    path = str(tmp_path / "x.wav")
    corpus.write_wav(path, a[1], 48000)
    y, sr = read_wav(path)
    assert sr == 48000 and np.allclose(y, a[1] / 32768.0, atol=1e-7)


def test_seed_streams_differ_and_fit_a_generator():
    s = {corpus.seed_stream(2 ** 31 + 99, k) for k in range(8)}
    assert len(s) == 8 and all(0 <= v < 2 ** 63 for v in s)
    torch.Generator().manual_seed(max(s))


def test_arrivals_have_the_rate_and_a_seeded_order():
    a = schedule(3000, 100.0, 30.0, 5)
    b = schedule(3000, 100.0, 30.0, 5)
    c = schedule(3000, 100.0, 30.0, 6)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) > 0) and a[-1] == pytest.approx(30.0) and a[0] > 0
    ga, gc = np.sort(np.diff(np.concatenate([[0], a]))), np.sort(np.diff(np.concatenate([[0], c])))
    assert np.allclose(ga, gc)
    gaps = np.diff(a)
    # exponential gaps: mean 1/rate, coefficient of variation 1
    assert gaps.mean() == pytest.approx(0.01, rel=0.02)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.05)
