"""PyTorch port front-end held against the JAX package on the CPU.

Numpy-seeded inputs go through both packages: the host helpers moved into
the port (MsConfig, front_end_consts, validate_filled_row), the DFT->mel
twin against the Pallas kernel in interpret mode, and mel_fn / seg_fn
against ``nisqa_tpu.data.pipeline._front_end`` on i16 and f32 buffers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nisqa_tpu.audio.melspec import pad_audio_for_batch
from nisqa_tpu.data import pipeline as jp
from nisqa_tpu_torch.data import pipeline as tp
from nisqa_tpu_torch.data.fill import validate_filled_row
from nisqa_tpu_torch.data.front_end import frame_geometry, front_end_consts, mel_fn, seg_fn
from nisqa_tpu_torch.ops import _build
from nisqa_tpu_torch.ops.dft_mel import dft_mel_reference, fused_dft_mel
from tests.test_e2e import TINY_ARGS

# the released model's front-end (nisqa_tpu/config/train_nisqa_cnn_sa_ap.yaml)
YAML_MS = {
    "ms_sr": None, "ms_fmax": 20000, "ms_n_fft": 4096, "ms_hop_length": 0.01,
    "ms_win_length": 0.02, "ms_n_mels": 48, "ms_seg_length": 15,
    "ms_seg_hop_length": 4, "ms_max_segments": 1300, "ms_channel": None,
}
# (id, ms args, sample rate, T bucket, file lengths in samples)
GEOMS = [
    ("tiny8k", TINY_ARGS, 8000, 13, [2000, 1500, 700]),
    ("yaml48k", YAML_MS, 48000, 163, [3 * 48000, 48000 + 1234]),
    ("yaml16k", YAML_MS, 16000, 163, [2 * 16000 + 17, 16000]),  # K = 2,049 (odd)
]
GEOM_IDS = [g[0] for g in GEOMS]


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("gid,args,sr,t_bucket,lengths", GEOMS, ids=GEOM_IDS)
def test_moved_helpers_equal_originals(gid, args, sr, t_bucket, lengths):
    mj, mt = jp.MsConfig(args), tp.MsConfig(args)
    assert vars(mj) == vars(mt)
    assert mj.buckets() == mt.buckets()
    for nw in (1, 7, t_bucket, mj.max_segments, mj.max_segments + 1):
        assert _outcome(mj.bucket_for, nw) == _outcome(mt.bucket_for, nw)
    for n in (0, 100, *lengths, 10 ** 7):
        nf = mj.n_frames(n, sr)
        assert nf == mt.n_frames(n, sr)
        assert _outcome(mj.n_wins, nf) == _outcome(mt.n_wins, nf)
        assert mj.frames_for_bucket(t_bucket) == mt.frames_for_bucket(t_bucket)
        for sr_got in (None, sr, sr + 1):
            assert (_outcome(jp.validate_filled_row, mj, "f.wav", n, sr, sr_got)
                    == _outcome(validate_filled_row, mt, "f.wav", n, sr, sr_got))
    for transport in ("f32", "i16"):
        cj = jp.front_end_consts(mj, sr, transport)
        ct = front_end_consts(mt, sr, transport)
        assert cj.keys() == ct.keys()
        for k in cj:
            np.testing.assert_array_equal(cj[k], ct[k])
    assert ct["w_re"].shape[1] == {"tiny8k": 256, "yaml48k": 1792, "yaml16k": 2049}[gid]


@pytest.mark.parametrize("bf16", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("gid,args,sr", [g[:3] for g in GEOMS], ids=GEOM_IDS)
def test_twin_matches_pallas_interpret(gid, args, sr, bf16):
    """The port's twin on unpadded constants vs the Pallas kernel (interpret
    mode) on its zero-padded ones. Fast mode rounds the same operands to bf16
    in both, so only the summation order differs."""
    from nisqa_tpu.ops.pallas_mel import fused_dft_mel as pallas_dft_mel, pad_consts_for_pallas

    c = jp.front_end_consts(jp.MsConfig(args), sr, "i16")
    cp = pad_consts_for_pallas(c, tile_k=128)
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((16, c["w_re"].shape[0])) * 3000).astype(np.float32)
    ref = np.asarray(pallas_dft_mel(frames, cp["w_re"], cp["w_im"], cp["fb_t"], tile_f=8,
                                    tile_k=128, bf16=bf16, interpret=True))
    got = dft_mel_reference(torch.from_numpy(frames), torch.from_numpy(c["w_re"]),
                            torch.from_numpy(c["w_im"]), torch.from_numpy(c["fb_t"]),
                            bf16=bf16).numpy()
    err = np.abs(got - ref).max()
    if bf16:
        assert err / np.abs(ref).max() <= 1e-4, err
    else:
        assert err <= 1e-4, err


def _buffers(ms, sr, t_bucket, lengths, seed=0):
    """The same PCM16 signals as an i16 buffer (engine i16 fill) and as an
    f32 buffer (x / 32768, engine f32 fill)."""
    buf_len = frame_geometry(ms, sr, t_bucket)[4]
    pad = ms.n_fft // 2
    rng = np.random.default_rng(seed)
    b = len(lengths)
    i16 = np.zeros((b, buf_len), np.int16)
    f32 = np.zeros((b, buf_len), np.float32)
    for j, ln in enumerate(lengths):
        x = np.clip(rng.standard_normal(ln) * 3000, -32768, 32767).astype(np.int16)
        i16[j, :pad] = x[pad:0:-1]
        w = min(ln, buf_len - pad)
        i16[j, pad:pad + w] = x[:w]
        take = min(pad, buf_len - (pad + ln))
        if take > 0:
            i16[j, pad + ln:pad + ln + take] = x[ln - 2:ln - 2 - take:-1]
        padded = pad_audio_for_batch(x.astype(np.float32) / 32768.0, ms.n_fft, ln + ms.n_fft)
        w = min(len(padded), buf_len)
        f32[j, :w] = padded[:w]
    return {"i16": i16, "f32": f32}, np.asarray(lengths, np.int32)


def _port_front_end(ms, sr, t_bucket, consts, buf, n):
    tc = {k: torch.from_numpy(v) for k, v in consts.items()}
    n_t = torch.from_numpy(n).long()
    db = mel_fn(ms, sr, t_bucket, tc, torch.from_numpy(buf), n_t)
    segs, n_wins = seg_fn(ms, sr, t_bucket, db, n_t)
    return db.numpy(), segs.numpy(), n_wins.numpy()


@pytest.mark.parametrize("gid,args,sr,t_bucket,lengths", GEOMS, ids=GEOM_IDS)
def test_mel_and_segments_match_jax(gid, args, sr, t_bucket, lengths):
    ms_j, ms_t = jp.MsConfig(args), tp.MsConfig(args)
    fe, buf_len = jp._front_end(ms_j, sr, t_bucket, pallas_mel=False, fe_fast=False)
    assert buf_len == frame_geometry(ms_t, sr, t_bucket)[4]
    bufs, n = _buffers(ms_t, sr, t_bucket, lengths)
    np.testing.assert_array_equal(bufs["i16"].astype(np.float32) / 32768.0, bufs["f32"])

    port = {}
    for transport, buf in bufs.items():
        consts = front_end_consts(ms_t, sr, transport)
        db_t, segs_t, nw_t = _port_front_end(ms_t, sr, t_bucket, consts, buf, n)
        cj = {k: jnp.asarray(v) for k, v in jp.front_end_consts(ms_j, sr, transport).items()}
        db_j = fe.mel_fn(cj, jnp.asarray(buf), jnp.asarray(n))
        segs_j, nw_j = fe.seg_fn(db_j, jnp.asarray(n))
        db_j, segs_j, nw_j = np.asarray(db_j), np.asarray(segs_j), np.asarray(nw_j)

        assert db_t.shape == db_j.shape == (len(lengths), ms_t.frames_for_bucket(t_bucket), ms_t.n_mels)
        assert np.abs(db_t - db_j).max() <= 1e-3
        np.testing.assert_array_equal(nw_t, nw_j)
        assert nw_t.tolist() == [ms_t.n_wins(ms_t.n_frames(int(x), sr)) for x in n]
        assert segs_t.shape == segs_j.shape == (len(lengths), t_bucket, ms_t.n_mels, ms_t.seg_length)
        np.testing.assert_array_equal(segs_t == 0, segs_j == 0)
        for b, nw in enumerate(nw_t):
            assert not segs_t[b, nw:].any()
        assert np.abs(segs_t - segs_j).max() <= 1e-3
        port[transport] = db_t
    # the i16 transport folds 1/32768 into the DFT weights: same mels
    assert np.abs(port["i16"] - port["f32"]).max() <= 1e-5


def test_wrapper_on_cpu_uses_twin_and_checks_inputs():
    rng = np.random.default_rng(1)
    f, wr, wi, fb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((7, 5), (5, 3), (5, 3), (3, 2)))
    before = fused_dft_mel.LAUNCHES
    for bf16 in (False, True):
        out = fused_dft_mel(f, wr, wi, fb, bf16=bf16)
        torch.testing.assert_close(out, dft_mel_reference(f, wr, wi, fb, bf16=bf16), rtol=0, atol=0)
    assert fused_dft_mel.LAUNCHES == before
    with pytest.raises(TypeError):
        fused_dft_mel(f.double(), wr, wi, fb)
    with pytest.raises(ValueError):
        fused_dft_mel(f, wr[:4], wi, fb)
    with pytest.raises(ValueError):
        fused_dft_mel(f, wr, wi, fb[:2])
    with pytest.raises(ValueError):
        fused_dft_mel(f[:0], wr, wi, fb)
    with pytest.raises(ValueError):
        fused_dft_mel(f.t().contiguous().t(), wr, wi, fb)
    with pytest.raises(ValueError):
        fused_dft_mel(f, wr, wi, fb.to("meta"))


def test_kernel_library_name_tracks_sources():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR + "/libnisqa_kernels_") and path.endswith(".so")
    assert path == _build.library_path()
    assert set(_build.SOURCES) <= set(__import__("os").listdir(_build.CSRC_DIR))
