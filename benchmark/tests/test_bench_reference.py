"""The plain reference against the port on the CPU at small sizes. The
reference imports nothing of the port; these tests import both."""

import numpy as np
import pytest
import torch

from benchmark import corpus, harness
from benchmark.reference import nisqa_ref as ref
from benchmark.weights import make_state


def _args():
    return harness.Cell("dim_corpus_cold").config["args"]


@pytest.mark.parametrize("sr,fmax,n_mels", [(48000, 20000, 48), (16000, 8000, 80)])
def test_filterbank_equals_the_ports(sr, fmax, n_mels):
    from nisqa_tpu_torch.audio.filters import mel_filterbank

    mine = ref.mel_filterbank(sr, 4096, n_mels, fmax)
    assert np.allclose(mine, mel_filterbank(sr, 4096, n_mels, 0.0, fmax), rtol=1e-6, atol=1e-9)


def test_front_end_and_segments_equal_the_ports_exact_path():
    from nisqa_tpu_torch.data.front_end import frame_geometry, mel_fn, seg_fn
    from nisqa_tpu_torch.data.pipeline import MsConfig, front_end_consts
    from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference

    args = _args()
    ms = MsConfig(args)
    pcm = corpus.synth(np.array([48000 * 3 + 123]), 48000, 3, "cpu")[0]
    n = len(pcm)
    nw = ms.n_wins(ms.n_frames(n, 48000))
    bucket = ms.bucket_for(nw)
    buf_len = frame_geometry(ms, 48000, bucket)[4]
    x = np.pad(pcm.astype(np.float32) / 32768.0, (2048, 2048), mode="reflect")
    buf = np.zeros((1, buf_len), np.float32)
    buf[0, :min(buf_len, len(x))] = x[:buf_len]
    consts = {k: torch.from_numpy(v) for k, v in front_end_consts(ms, 48000, "f32").items()}
    nn_ = torch.tensor([n])
    db = mel_fn(ms, 48000, bucket, consts, torch.from_numpy(buf), nn_, dft_mel=dft_mel_reference)
    segs, n_wins = seg_fn(ms, 48000, bucket, db, nn_)
    fe = ref.FrontEnd(args, 48000, "cpu")
    mine = fe.db(pcm)
    f = fe.frames(n)
    assert torch.allclose(mine, db[0, :f], atol=2e-3)
    s = ref.segments(mine, 15, 4)
    assert len(s) == int(n_wins[0]) == nw
    assert torch.allclose(s, segs[0, :nw], atol=2e-3)


def test_segments_equal_the_host_reference():
    from nisqa_tpu_torch.features.segments import segment_np

    spec = np.random.default_rng(0).standard_normal((48, 97)).astype(np.float32)
    want, nw = segment_np(spec, 15, 4, 40)
    got = ref.segments(torch.from_numpy(spec).T, 15, 4)
    assert np.array_equal(got.numpy(), want[:nw])


@pytest.mark.parametrize("model,heads", [("NISQA_DIM", 5), ("NISQA", 1)])
def test_eval_model_equals_the_ports(model, heads, one_thread):
    from nisqa_tpu_torch.models.nisqa import build_model

    args = _args()
    state = make_state(ref.param_spec(args, heads), 4, "cpu", "trained")
    m = build_model(model, args)
    m.load_state_dict(state, strict=True)
    m.eval()
    g = torch.Generator().manual_seed(1)
    lens = [23, 9, 40]
    segs = [torch.randn(n, 48, 15, generator=g) * 10 for n in lens]
    x = torch.zeros(len(lens), max(lens), 48, 15)
    for i, s in enumerate(segs):
        x[i, :len(s)] = s
    with torch.no_grad():
        port = m(x, torch.tensor(lens))
        mine = ref.predict(state, args, segs)
    assert torch.allclose(port, mine, atol=2e-5, rtol=1e-5)


def test_weights_repeat_by_seed_and_style():
    args = _args()
    spec = ref.param_spec(args, 5)
    a, b = make_state(spec, 9, "cpu", "trained"), make_state(spec, 9, "cpu", "trained")
    s = make_state(spec, 9, "cpu", "scratch")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(s["cnn.model.bn1.weight"], torch.ones(16))
    assert not torch.equal(a["cnn.model.bn1.running_var"], torch.ones(16))
    w = a["cnn.model.conv2.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(16 * 9) + 1e-7
