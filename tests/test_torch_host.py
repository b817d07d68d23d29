"""The port's copies of the JAX package's host modules held equal to the originals.

``nisqa_tpu_torch`` imports nothing of ``nisqa_tpu``: it keeps its own copies
of the audio decoders, the filterbank, the batch-row padding, the native
loader's bindings and the model-args extraction. The same inputs go through
both copies here (only tests import both packages): WAV and FLAC decode
bit-identical through the Python decoders and through the native loader,
filterbanks bit-identical, model args equal on every golden's args, the
host segmentation reference equal (errors included) and the port's batched
``seg_fn`` equal to it per file.
"""

import glob
import io
import json
import os
import struct

import numpy as np
import pytest

from nisqa_tpu.audio import codec as jax_codec
from nisqa_tpu.audio import filters as jax_filters
from nisqa_tpu.audio import flac as jax_flac
from nisqa_tpu.audio import melspec as jax_melspec
from nisqa_tpu.audio import wav as jax_wav
from nisqa_tpu.compat.model_args import model_args_from_ckpt_args as jax_model_args
from nisqa_tpu.data import native as jax_native
from nisqa_tpu.features import segments as jax_segments
from nisqa_tpu_torch.audio import codec, filters, melspec
from nisqa_tpu_torch.audio import wav as wavio
from nisqa_tpu_torch.compat.model_args import model_args_from_ckpt_args
from nisqa_tpu_torch.data import native
from nisqa_tpu_torch.features import segments
from tests.test_e2e import TINY_ARGS

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PAD = 256


def _wav_bytes(payload, fmt, channels, sr, bits):
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, sr, sr * channels * bits // 8,
                            channels * bits // 8, bits)
    b = io.BytesIO()
    b.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(payload)) + b"WAVE")
    b.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
    b.write(b"data" + struct.pack("<I", len(payload)) + payload)
    return b.getvalue()


def _make(tmp_path, case):
    """One file of the named format, from a seeded signal."""
    rng = np.random.default_rng(CASES.index(case))
    n = 3001
    x = np.clip(0.3 * rng.standard_normal((2, n)), -1, 1)
    path = tmp_path / f"{case}.{'flac' if case.startswith('flac') else 'wav'}"
    if case == "pcm16_mono":
        jax_wav.write_wav(str(path), x[0].astype(np.float32), 16000)
    elif case == "pcm16_stereo":
        jax_wav.write_wav(str(path), x.astype(np.float32), 16000)
    elif case == "pcm24_stereo":
        v = np.round(x.T.reshape(-1) * ((1 << 23) - 1)).astype(np.int64)
        raw = b"".join(int(s & 0xFFFFFF).to_bytes(3, "little") for s in v)
        path.write_bytes(_wav_bytes(raw, 1, 2, 44100, 24))
    elif case == "float32_stereo":
        path.write_bytes(_wav_bytes(x.T.astype("<f4").tobytes(), 3, 2, 48000, 32))
    elif case == "flac_mono":
        jax_flac.write_flac(str(path), x[0], 16000, predictor="lpc")
    elif case == "flac_stereo":
        jax_flac.write_flac(str(path), x.T, 8000, mode="mid-side")
    return str(path)


CASES = ["pcm16_mono", "pcm16_stereo", "pcm24_stereo", "float32_stereo", "flac_mono", "flac_stereo"]


@pytest.mark.parametrize("case", CASES)
def test_python_decode_bit_identical(tmp_path, case):
    path = _make(tmp_path, case)
    for channel in (None, 0, 1, -1):
        y, sr = wavio.read_wav(path, channel=channel)
        y_ref, sr_ref = jax_wav.read_wav(path, channel=channel)
        assert sr == sr_ref and y.dtype == y_ref.dtype
        np.testing.assert_array_equal(y, y_ref)
    raw, raw_ref = wavio.read_wav_pcm16_mono(path), jax_wav.read_wav_pcm16_mono(path)
    assert (raw is None) == (raw_ref is None) == (case not in ("pcm16_mono", "flac_mono"))
    if raw is not None:
        assert raw[1] == raw_ref[1]
        np.testing.assert_array_equal(raw[0], raw_ref[0])


@pytest.mark.parametrize("case", CASES)
def test_native_decode_bit_identical(tmp_path, case):
    """The port's own build of ``native/wavloader.cpp`` scans and fills the
    same bits as the JAX package's, and its f32 rows equal the Python
    decoder's reflect-padded rows."""
    assert native.available() and jax_native.available()
    path = _make(tmp_path, case)
    scans = native.scan_audio([path]), jax_native.scan_audio([path])
    for a, b in zip(*scans):
        np.testing.assert_array_equal(a, b)
    n_samples, kind = int(scans[0][0][0]), int(scans[0][2][0])
    buf_len = n_samples + 2 * PAD + 64
    for channel in (None, 0, -1):
        rows = [np.full((2, buf_len), 7.0, np.float32) for _ in range(2)]
        out = native.fill_batch_f32([path], rows[0], PAD, channel=channel, n_threads=2)
        ref = jax_native.fill_batch_f32([path], rows[1], PAD, channel=channel, n_threads=2)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rows[0], rows[1])
        if out[2][0] == 0:
            y, _ = wavio.read_wav(path, channel=channel)
            padded = melspec.pad_audio_for_batch(y, 2 * PAD, len(y) + 2 * PAD)
            np.testing.assert_array_equal(rows[0][0, : len(padded)], padded)
    if kind == 0:
        rows = [np.zeros((1, buf_len), np.int16) for _ in range(2)]
        out = native.fill_batch_i16([path], rows[0], PAD, n_threads=2)
        ref = jax_native.fill_batch_i16([path], rows[1], PAD, n_threads=2)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rows[0], rows[1])
        raw, _ = wavio.read_wav_pcm16_mono(path)
        np.testing.assert_array_equal(rows[0][0, PAD : PAD + len(raw)], raw)


def test_native_libraries_are_built_in_the_port(tmp_path):
    """The port loads the libraries it compiled into ``_build/``, never one
    from ``native/``; its codec shim decodes what the JAX package's does."""
    assert native.available() and codec.available()
    for lib, stem in ((native._lib, "libwavloader_"), (codec._lib, "libcodecdecode_")):
        assert os.path.dirname(lib._name) == native.BUILD_DIR
        assert os.path.basename(lib._name).startswith(stem)
    path = str(tmp_path / "tone.mp3")
    t = np.arange(24000) / 48000
    jax_codec.encode(path, (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), 48000)
    y, sr = codec.decode(path)
    y_ref, sr_ref = jax_codec.decode(path)
    assert sr == sr_ref and len(y) > 0
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(wavio.read_wav(path)[0], jax_wav.read_wav(path)[0])


@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_filterbank_and_window_bit_identical(sr):
    win = int(sr * 0.02)
    for n_fft, n_mels, fmax in ((4096, 48, 20000.0), (512, 24, 4000.0)):
        np.testing.assert_array_equal(filters.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax),
                                      jax_filters.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax))
        np.testing.assert_array_equal(filters.padded_window(min(win, n_fft), n_fft),
                                      jax_filters.padded_window(min(win, n_fft), n_fft))
    y = np.random.default_rng(sr).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(melspec.pad_audio_for_batch(y, 512, 1600),
                                  jax_melspec.pad_audio_for_batch(y, 512, 1600))


def _golden_args():
    out = {"tiny": TINY_ARGS}
    for path in sorted(glob.glob(os.path.join(GOLDENS, "g*.npz"))):
        z = np.load(path, allow_pickle=False)
        if "meta" in z.files:
            meta = json.loads(str(z["meta"]))
            if "model_args" in meta:
                out[os.path.basename(path)[:-4]] = {**meta["model_args"], "model": meta["model"]}
    return out


def test_model_args_equal_on_goldens():
    cases = _golden_args()
    assert len(cases) >= 10
    for name, args in cases.items():
        assert model_args_from_ckpt_args(dict(args)) == jax_model_args(dict(args)), name


# (n_mels, frames, seg_length, seg_hop, max_length): tests/test_audio.py's
# case, hop 1 filling max_length exactly, the dry run's 24-mel geometry, and
# the three errors
SEG_CASES = {"hop4": (48, 100, 15, 4, 40), "hop1_full": (48, 100, 15, 1, 86),
             "tiny": (24, 71, 7, 2, 64), "even_seg_length": (48, 30, 14, 1, 20),
             "too_short": (48, 10, 15, 1, 20), "over_max_length": (48, 100, 15, 4, 10)}


def _outcome(fn, *args):
    """("ok", result) or ("raised", the error's type and message)."""
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "raised", (type(e), str(e))


@pytest.mark.parametrize("case", SEG_CASES)
def test_segment_np_equal(case):
    n_mels, w, s, hop, max_length = SEG_CASES[case]
    spec = np.random.default_rng(1).standard_normal((n_mels, w)).astype(np.float32)
    kind, got = _outcome(segments.segment_np, spec, s, hop, max_length)
    want = _outcome(jax_segments.segment_np, spec, s, hop, max_length)
    assert kind == want[0], (got, want)
    if kind == "raised":
        assert got == want[1]
    else:
        np.testing.assert_array_equal(got[0], want[1][0])
        assert got[0].dtype == want[1][0].dtype and got[1] == want[1][1]


@pytest.mark.parametrize("n_frames,seg_length,seg_hop",
                         [(100, 15, 1), (100, 15, 4), (15, 15, 4), (71, 7, 2), (14, 15, 4),
                          (10, 15, 1)])
def test_n_wins_for_equal(n_frames, seg_length, seg_hop):
    got = _outcome(segments.n_wins_for, n_frames, seg_length, seg_hop)
    assert got == _outcome(jax_segments.n_wins_for, n_frames, seg_length, seg_hop)


@pytest.mark.parametrize("seg_length,seg_hop,t_bucket", [(15, 4, 40), (15, 1, 90), (7, 2, 64)])
def test_port_seg_fn_matches_segment_np_per_file(seg_length, seg_hop, t_bucket):
    """The port's batched windowing (``data/front_end.py::seg_fn``) against
    the copy's per-file oracle, as tests/test_audio.py holds nisqa_tpu's."""
    import torch

    from nisqa_tpu_torch.data.front_end import seg_fn
    from nisqa_tpu_torch.data.pipeline import MsConfig

    sr = 8000
    hop = int(sr * 0.01)
    ms = MsConfig({"ms_seg_length": seg_length, "ms_seg_hop_length": seg_hop,
                   "ms_max_segments": 160})
    w = ms.frames_for_bucket(t_bucket)  # the front-end's frames at this bucket
    spec = np.random.default_rng(2).standard_normal((2, w, 48)).astype(np.float32)
    n_frames = np.array([100, 57], dtype=np.int32)
    n_samples = ((n_frames - 1) * hop).astype(np.int32)  # n_frames = 1 + n // hop
    segs, n_wins = seg_fn(ms, sr, t_bucket, torch.from_numpy(spec), torch.from_numpy(n_samples))
    for b in range(2):
        ref, ref_n = segments.segment_np(spec[b, : n_frames[b]].T, seg_length, seg_hop, t_bucket)
        assert int(n_wins[b]) == ref_n
        np.testing.assert_array_equal(segs[b].numpy(), ref)
