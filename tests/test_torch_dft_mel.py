"""The DFT->mel kernel's arithmetic and layout, held on the CPU.

The CUDA kernel (``nisqa_tpu_torch/csrc/dft_mel.cu``) runs only on the
card. What it computes is pinned here: ``prepare_consts`` (the kernel's
constant layout) is run through a plain emulation of the kernel's
arithmetic (3xTF32 or bf16 DFT on the interleaved K-major weights, TF32
rounding by integer bit operations, |.| per bin, the band-limited mel step
in the kernel's summation order) and held against the twin and the Pallas
kernel in interpret mode. Inputs are numpy-seeded PCM16-like frames through
the main path's constants (``front_end_consts(ms, sr, "i16")``).
"""

import numpy as np
import pytest
import torch

from nisqa_tpu.ops.pallas_mel import fused_dft_mel as pallas_dft_mel, pad_consts_for_pallas
from nisqa_tpu_torch.data import pipeline as tp
from nisqa_tpu_torch.data.front_end import mel_fn
from nisqa_tpu_torch.ops import dft_mel as dm
from tests.test_e2e import TINY_ARGS
from tests.test_torch_front_end import YAML_MS

# the released NISQA-TTS model's front-end: fmax 8 kHz keeps K = 768 bins at 48 kHz
TTS_MS = {**YAML_MS, "ms_fmax": 8000, "ms_seg_hop_length": 1, "ms_max_segments": 6000}
GEOMS = [("tiny8k", TINY_ARGS, 8000), ("yaml48k", YAML_MS, 48000), ("yaml16k", YAML_MS, 16000),
         ("tts48k", TTS_MS, 48000)]
GEOM_IDS = [g[0] for g in GEOMS]
H100_SMS = 132
EXACT_BOUND, FAST_BOUND = 1e-5, 1e-4  # relative to max|reference|, as chip_smoke.py holds the kernel
MODES = [(False, EXACT_BOUND), (True, FAST_BOUND)]
MODE_IDS = ["exact", "fast"]


def _consts(args, sr):
    c = tp.front_end_consts(tp.MsConfig(args), sr, "i16")
    return {k: torch.from_numpy(v) for k, v in c.items()}


def _frames(n, span, seed=0):
    rng = np.random.default_rng(seed)
    x = np.clip(np.round(rng.standard_normal((n, span)) * 3000), -32768, 32767)
    return torch.from_numpy(x.astype(np.float32))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def emulate_dft(frames, kc, bf16, passes=3):
    """(N, Kp) magnitudes as the kernel forms them from ``prepare_consts``."""
    n, span = frames.shape
    w = kc["w"]
    a = torch.zeros((n, w.shape[1]))
    a[:, :span] = frames
    if bf16:
        acc = a.to(torch.bfloat16).float() @ w.float().t()
    elif passes == 1:  # one TF32 pass, for contrast: never what the kernel does
        acc = dm.round_tf32(a) @ w.t()
    else:
        a_hi, a_lo = dm.tf32_split(a)
        acc = a_hi @ kc["w_lo"].t() + a_lo @ w.t() + a_hi @ w.t()
    re, im = acc[:, 0::2], acc[:, 1::2]
    return torch.sqrt(re * re + im * im)


def mel_step(mag, fb, tiles):
    """The kernel's mel step over (K tile, m_lo, m_hi) rows: lane q of a
    quad sums bins 4j + q in order, the quad adds (p0 + p1) + (p2 + p3),
    and the tile's sum is added into the mel tile. Every operation is
    elementwise, so a column's bits do not depend on which columns run."""
    k, m = fb.shape
    out = torch.zeros((mag.shape[0], m))
    for t, lo, hi in tiles:
        p = [torch.zeros((mag.shape[0], hi - lo)) for _ in range(4)]
        for q in range(4):
            for j in range(dm.BINS_PER_TILE // 4):
                b = t * dm.BINS_PER_TILE + 4 * j + q
                if b < k:
                    p[q] = p[q] + mag[:, b, None] * fb[b, lo:hi]
        out[:, lo:hi] = out[:, lo:hi] + ((p[0] + p[1]) + (p[2] + p[3]))
    return out


def emulate_kernel(frames, kc, bf16, passes=3):
    return mel_step(emulate_dft(frames, kc, bf16, passes), kc["fb"], kc["tiles"].tolist())


@pytest.mark.parametrize("bf16,bound", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("gid,args,sr", GEOMS, ids=GEOM_IDS)
def test_kernel_arithmetic_matches_twin_and_pallas(gid, args, sr, bf16, bound):
    c = _consts(args, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16)
    frames = _frames(256, c["w_re"].shape[0])
    got = emulate_kernel(frames, kc, bf16)
    twin = dm.dft_mel_reference(frames, c["w_re"], c["w_im"], c["fb_t"], bf16=bf16)
    assert got.shape == twin.shape and bool(torch.isfinite(got).all())
    assert _rel(got, twin) <= bound, _rel(got, twin)

    cp = pad_consts_for_pallas({k: v.numpy() for k, v in c.items()}, tile_k=128)
    pallas = np.array(pallas_dft_mel(frames[:16].numpy(), cp["w_re"], cp["w_im"], cp["fb_t"],
                                       tile_f=8, tile_k=128, bf16=bf16, interpret=True))
    assert _rel(got[:16], torch.from_numpy(pallas)) <= bound


@pytest.mark.parametrize("gid,args,sr", GEOMS, ids=GEOM_IDS)
def test_band_skipping_and_k_padding_are_bit_identical(gid, args, sr):
    c = _consts(args, sr)
    k, m = c["fb_t"].shape
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=False)
    mag = emulate_dft(_frames(64, c["w_re"].shape[0]), kc, bf16=False)
    assert not mag[:, k:].any()  # padded bins: zero weights, |0| = 0
    banded = mel_step(mag, kc["fb"], kc["tiles"].tolist())
    # the dense step on the unpadded constants: every tile, every mel band
    dense = mel_step(mag[:, :k], c["fb_t"], [(t, 0, m) for t in range(-(-k // dm.BINS_PER_TILE))])
    assert torch.equal(banded, dense)


@pytest.mark.parametrize("gid,args,sr", GEOMS[1:], ids=GEOM_IDS[1:])
def test_single_tf32_pass_fails_the_exact_bound(gid, args, sr):
    """Why exact mode takes three TF32 products: one pass misses even the
    fast bound (2e-4 off, relative to max)."""
    c = _consts(args, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=False)
    frames = _frames(256, c["w_re"].shape[0])
    twin = dm.dft_mel_reference(frames, c["w_re"], c["w_im"], c["fb_t"])
    one = _rel(emulate_kernel(frames, kc, False, passes=1), twin)
    three = _rel(emulate_kernel(frames, kc, False), twin)
    assert one > FAST_BOUND > EXACT_BOUND >= three, (one, three)


@pytest.mark.parametrize("gid,args,sr", GEOMS, ids=GEOM_IDS)
def test_prepared_layout(gid, args, sr):
    c = _consts(args, sr)
    span, k = c["w_re"].shape
    m = c["fb_t"].shape[1]
    fast = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=True)
    exact = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=False)
    kp = exact["k_pad"]
    assert kp % dm.BINS_PER_TILE == 0 and kp - dm.BINS_PER_TILE < k <= kp
    sp = exact["w"].shape[1]
    assert sp % dm.SPAN_ALIGN == 0 and sp * 2 % 16 == 0 and span <= sp
    assert exact["w"].shape == exact["w_lo"].shape == fast["w"].shape == (2 * kp, sp)
    assert fast["w"].dtype == torch.bfloat16 and "w_lo" not in fast
    # interleaved, K-major: row 2j is bin j's cos column, row 2j + 1 its sin column
    w = exact["w"] + exact["w_lo"]
    assert torch.allclose(w[0:2 * k:2, :span], c["w_re"].t(), rtol=2 ** -21, atol=0)
    assert torch.allclose(w[1:2 * k:2, :span], c["w_im"].t(), rtol=2 ** -21, atol=0)
    assert torch.equal(fast["w"][0:2 * k:2, :span], c["w_re"].t().to(torch.bfloat16))
    assert not exact["w"][2 * k:].any() and not exact["w"][:, span:].any()
    assert not fast["w"][2 * k:].any() and not fast["w"][:, span:].any()
    # TF32 values: the low 13 mantissa bits are zero
    for t in (exact["w"], exact["w_lo"]):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(exact["fb"][:k], c["fb_t"])
    assert exact["fb"].shape == (kp, m) and not exact["fb"][k:].any()
    # band tiles against a brute-force scan of fb
    fb = exact["fb"].numpy()
    want = []
    for t in range(kp // dm.BINS_PER_TILE):
        cols = np.nonzero(fb[t * dm.BINS_PER_TILE:(t + 1) * dm.BINS_PER_TILE].any(axis=0))[0]
        if len(cols):
            want.append([t, cols[0], cols[-1] + 1])
    assert exact["tiles"].dtype == torch.int32 and exact["tiles"].tolist() == want
    assert torch.equal(fast["tiles"], exact["tiles"])


def test_round_tf32_is_round_to_nearest_away():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * 1e3
    bits = x.view(np.uint32)
    ties = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)).view(np.float32)  # exact halfway
    for v in (x, ties, -ties, np.float32([0.0, -0.0, 1.0, 32767.0, -32768.0])):
        got = dm.round_tf32(torch.from_numpy(v)).numpy().astype(np.float64)
        v64 = v.astype(np.float64)
        ulp = np.exp2(np.floor(np.log2(np.abs(np.where(v64 == 0, 1, v64)))) - 10)
        want = np.sign(v64) * np.floor(np.abs(v64) / ulp + 0.5) * ulp
        np.testing.assert_array_equal(got, want)
    hi, lo = dm.tf32_split(torch.from_numpy(x))
    assert torch.allclose(hi + lo, torch.from_numpy(x), rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("n,row_tiles,splits", [(43, 1, 27), (21216, 166, 1), (166752, 1303, 1)])
def test_plan_grid(n, row_tiles, splits):
    k_tiles = len(dm.prepare_consts(*_consts(YAML_MS, 48000).values(), bf16=True)["tiles"])
    assert k_tiles == 27  # 28 tiles of 64 bins; the last (bins 1,728-1,791) touches no band
    rt, sp, per = dm.plan_grid(n, k_tiles, H100_SMS)
    assert (rt, sp) == (row_tiles, splits)
    assert rt * dm.ROWS_PER_BLOCK >= n and (sp - 1) * per < k_tiles <= sp * per


@pytest.mark.parametrize("n,row_tiles,splits", [(1001, 8, 11), (8 * 6014, 376, 1)])
def test_plan_grid_tts(n, row_tiles, splits):
    """The TTS shapes: 11 active K tiles of 12 (bins 704-767 touch no band),
    the largest bucket's 8 x 6,014 rows and a small ragged N split over K."""
    kc = dm.prepare_consts(*_consts(TTS_MS, 48000).values(), bf16=True)
    assert kc["k_pad"] == 768 and len(kc["tiles"]) == 11
    rt, sp, per = dm.plan_grid(n, len(kc["tiles"]), H100_SMS)
    assert (rt, sp) == (row_tiles, splits)
    assert rt * dm.ROWS_PER_BLOCK >= n and (sp - 1) * per < len(kc["tiles"]) <= sp * per


def test_plan_grid_edges():
    assert dm.plan_grid(1, 0, H100_SMS) == (1, 1, 0)
    assert dm.plan_grid(1, 1, H100_SMS) == (1, 1, 1)
    assert dm.plan_grid(10 * 128, 27, H100_SMS) == (10, 14, 2)
    assert dm.plan_grid(132 * 128, 27, H100_SMS) == (132, 1, 27)


def test_bf16_frames_are_the_twins_operands():
    """mel_fn rounds fast-mode frames to bf16 straight from the int16 (or
    float32) buffer; the values are those of the twin's float32 -> bf16."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    assert torch.equal(x.to(torch.bfloat16).view(torch.int16),
                       x.float().to(torch.bfloat16).view(torch.int16))
    ms = tp.MsConfig(YAML_MS)
    c = _consts(YAML_MS, 48000)
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(np.clip(rng.standard_normal((2, 48000)) * 3000, -32768, 32767)
                           .astype(np.int16))
    n = torch.tensor([40000, 30000])
    seen = {}

    def spy(frames, w_re, w_im, fb, bf16):
        seen[bf16] = frames
        return dm.dft_mel_reference(frames, w_re, w_im, fb, bf16)

    fast = mel_fn(ms, 48000, 8, c, buf, n, fast=True, dft_mel=spy)
    exact = mel_fn(ms, 48000, 8, c, buf, n, fast=False, dft_mel=spy)
    assert seen[True].dtype == torch.bfloat16 and seen[False].dtype == torch.float32
    assert torch.equal(seen[True], seen[False].to(torch.bfloat16))
    assert torch.equal(dm.dft_mel_reference(seen[True], c["w_re"], c["w_im"], c["fb_t"], True),
                       dm.dft_mel_reference(seen[False], c["w_re"], c["w_im"], c["fb_t"], True))
    assert (fast - exact).abs().max() < 0.1  # dB


def test_preparation_is_cached_per_constant_tensors():
    c = _consts(TINY_ARGS, 8000)
    before = dm.fused_dft_mel.PREPARATIONS
    a = dm._kernel_consts(c["w_re"], c["w_im"], c["fb_t"], True)
    assert dm._kernel_consts(c["w_re"], c["w_im"], c["fb_t"], True) is a
    assert dm.fused_dft_mel.PREPARATIONS == before + 1
    dm._kernel_consts(c["w_re"], c["w_im"], c["fb_t"], False)  # the other mode
    w_re2 = c["w_re"].clone()
    dm._kernel_consts(w_re2, c["w_im"], c["fb_t"], True)       # other tensors
    assert dm.fused_dft_mel.PREPARATIONS == before + 3
    n_entries = len(dm._PREPARED)
    del w_re2
    assert len(dm._PREPARED) == n_entries - 1  # the entry goes with its tensors


def test_wrapper_takes_bf16_frames_only_in_fast_mode():
    rng = np.random.default_rng(1)
    f, wr, wi, fb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((7, 5), (5, 3), (5, 3), (3, 2)))
    before = dm.fused_dft_mel.PREPARATIONS, dm.fused_dft_mel.LAUNCHES
    out = dm.fused_dft_mel(f.to(torch.bfloat16), wr, wi, fb, bf16=True)
    assert torch.equal(out, dm.dft_mel_reference(f, wr, wi, fb, bf16=True))
    assert (dm.fused_dft_mel.PREPARATIONS, dm.fused_dft_mel.LAUNCHES) == before  # CPU: the twin
    with pytest.raises(TypeError):
        dm.fused_dft_mel(f.to(torch.bfloat16), wr, wi, fb, bf16=False)
    with pytest.raises(TypeError):
        dm.fused_dft_mel(f, wr.to(torch.bfloat16), wi, fb, bf16=True)

