"""The DFT->mel kernel's arithmetic and layout, held on the CPU.

The CUDA kernel (``nisqa_tpu_torch/csrc/dft_mel.cu``) runs only on the
card. What it computes is pinned here: ``prepare_consts`` (the kernel's
constant layout) is run through a plain emulation of the kernel's
arithmetic (3xTF32 or bf16 DFT on the interleaved K-major weights, TF32
rounding by integer bit operations, |.| per bin, the band-limited mel step
in the kernel's summation order) and held against the twin and the Pallas
kernel in interpret mode. Inputs are numpy-seeded PCM16-like frames through
the main path's constants (``front_end_consts(ms, sr, "i16")``). Above 64
mel bands the kernel takes the bands in chunks of 64 (``chunk_tiles``): the
chunked plan is held to the one-chunk tile list it is cut from, bit for bit
through the emulation, split K included.
"""

import jax
import numpy as np
import pytest
import torch

from nisqa_tpu.ops.pallas_mel import fused_dft_mel as pallas_dft_mel, pad_consts_for_pallas
from nisqa_tpu_torch.data import pipeline as tp
from nisqa_tpu_torch.data.front_end import front_end_consts, mel_fn
from nisqa_tpu_torch.ops import dft_mel as dm
from tests.test_e2e import TINY_ARGS
from tests.test_torch_front_end import YAML_MS

# the released NISQA-TTS model's front-end: fmax 8 kHz keeps K = 768 bins at 48 kHz
TTS_MS = {**YAML_MS, "ms_fmax": 8000, "ms_seg_hop_length": 1, "ms_max_segments": 6000}
GEOMS = [("tiny8k", TINY_ARGS, 8000), ("yaml48k", YAML_MS, 48000), ("yaml16k", YAML_MS, 16000),
         ("tts48k", TTS_MS, 48000)]
# 80 mel bands: two chunks of the kernel's shared mel tile
GEOMS += [(f"{gid}-m80", {**args, "ms_n_mels": 80}, sr) for gid, args, sr in GEOMS[:3]]
GEOM_IDS = [g[0] for g in GEOMS]
# the chunked plan at 80, 128 and 200 bands (200: four chunks, the last of 8 bands)
CHUNK_GEOMS = [(f"{gid}-m{m}", {**args, "ms_n_mels": m}, sr)
               for gid, args, sr in GEOMS[:3] for m in (80, 128, 200)]
CHUNK_IDS = [g[0] for g in CHUNK_GEOMS]
H100_SMS = 132
EXACT_BOUND, FAST_BOUND = 1e-5, 1e-4  # relative to max|reference|, as chip_smoke.py holds the kernel
MODES = [(False, EXACT_BOUND), (True, FAST_BOUND)]
MODE_IDS = ["exact", "fast"]


def _consts(args, sr):
    c = front_end_consts(tp.MsConfig(args), sr, "i16")
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


def split_mel_step(mag, fb, rows, per):
    """The kernel's mel step over chunked-plan rows (K tile, m_lo, m_hi, t)
    under split K: split s takes the rows with t in [s * per, s * per + per)
    (per 0: one split, every row), and the splits' partial mels are added
    in split order (sum_splits_kernel)."""
    if not per:
        return mel_step(mag, fb, [r[:3] for r in rows])
    splits = -(-(max(r[3] for r in rows) + 1) // per)
    parts = [mel_step(mag, fb, [r[:3] for r in rows if s * per <= r[3] < s * per + per])
             for s in range(splits)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def one_chunk_rows(kc):
    """The one-chunk plan over every band: ``tiles`` with t = 0..T-1."""
    return [[*r, t] for t, r in enumerate(kc["tiles"].tolist())]


def emulate_kernel(frames, kc, bf16, passes=3, per=0):
    """The kernel's output from its chunked plan (split K by ``per``)."""
    return split_mel_step(emulate_dft(frames, kc, bf16, passes), kc["fb"],
                          kc["chunk_tiles"].tolist(), per)


@pytest.mark.parametrize("bf16,bound", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("gid,args,sr", GEOMS, ids=GEOM_IDS)
def test_kernel_arithmetic_matches_twin_and_pallas(gid, args, sr, bf16, bound):
    c = _consts(args, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16)
    frames = _frames(256, c["w_re"].shape[0])
    got = emulate_kernel(frames, kc, bf16)
    twin = dm.dft_mel_reference(frames, c["w_re"], c["w_im"], c["fb_t"], bf16=bf16)
    assert got.shape == twin.shape and bool(torch.isfinite(got).all())
    # the precisions in force, for a failure's message: the twin's matmuls and JAX's default
    where = (f"torch float32 matmul precision {torch.get_float32_matmul_precision()!r}, "
             f"jax_default_matmul_precision {jax.config.jax_default_matmul_precision!r}")
    rel = _rel(got, twin)
    assert rel <= bound, f"emulated kernel vs twin: rel {rel} > {bound} ({where})"

    cp = pad_consts_for_pallas({k: v.numpy() for k, v in c.items()}, tile_k=128)
    pallas = np.array(pallas_dft_mel(frames[:16].numpy(), cp["w_re"], cp["w_im"], cp["fb_t"],
                                       tile_f=8, tile_k=128, bf16=bf16, interpret=True))
    rel = _rel(got[:16], torch.from_numpy(pallas))
    assert rel <= bound, f"emulated kernel vs Pallas (interpret): rel {rel} > {bound} ({where})"


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


@pytest.mark.parametrize("gid,args,sr", [g for g in GEOMS if not g[0].startswith("tiny")],
                         ids=[i for i in GEOM_IDS if not i.startswith("tiny")])
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


@pytest.mark.parametrize("gid,args,sr", CHUNK_GEOMS, ids=CHUNK_IDS)
def test_chunked_plan_covers_every_band_once(gid, args, sr):
    """Each nonzero filterbank entry (bin, band) lies in exactly one row of
    the chunked plan; rows stay inside their chunk, in K order, each a
    clipped copy of the one-chunk tile it names; a chunk no tile touches
    has no rows and gives zero columns."""
    c = _consts(args, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=False)
    m = c["fb_t"].shape[1]
    tiles, rows = kc["tiles"].tolist(), kc["chunk_tiles"].tolist()
    starts = kc["chunk_start"].tolist()
    assert kc["chunk_tiles"].dtype == kc["chunk_start"].dtype == torch.int32
    assert len(starts) == -(-m // dm.MEL_CHUNK) + 1 and starts[0] == 0 and starts[-1] == len(rows)
    cover = np.zeros(tuple(kc["fb"].shape), np.int64)
    for ch in range(len(starts) - 1):
        c0, c1 = ch * dm.MEL_CHUNK, min(ch * dm.MEL_CHUNK + dm.MEL_CHUNK, m)
        mine = rows[starts[ch]:starts[ch + 1]]
        assert [r[0] for r in mine] == sorted({r[0] for r in mine})  # K order, once each
        for kt, lo, hi, t in mine:
            assert c0 <= lo < hi <= c1 and tiles[t][0] == kt
            assert (max(tiles[t][1], c0), min(tiles[t][2], c1)) == (lo, hi)
            cover[kt * dm.BINS_PER_TILE:(kt + 1) * dm.BINS_PER_TILE, lo:hi] += 1
    fb = kc["fb"].numpy()
    assert (cover[fb != 0] == 1).all()
    assert cover.max() <= 1
    # the emulated kernel: columns of chunks without rows are zero
    empty = [ch for ch in range(len(starts) - 1) if starts[ch] == starts[ch + 1]]
    if gid.startswith("yaml16k-m80"):  # bands 64-79 lie above 8 kHz: all-zero filters
        assert empty == [1]
    got = emulate_kernel(_frames(8, c["w_re"].shape[0]), kc, bf16=True)
    for ch in empty:
        assert not got[:, ch * dm.MEL_CHUNK:(ch + 1) * dm.MEL_CHUNK].any()
        assert not fb[:, ch * dm.MEL_CHUNK:(ch + 1) * dm.MEL_CHUNK].any()


@pytest.mark.parametrize("m", [1, 24, 48, 63, 64])
@pytest.mark.parametrize("gid,args,sr", GEOMS[:4], ids=GEOM_IDS[:4])
def test_chunked_plan_is_the_tile_list_up_to_64_bands(gid, args, sr, m):
    c = _consts({**args, "ms_n_mels": m}, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=True)
    assert kc["chunk_tiles"].tolist() == one_chunk_rows(kc)
    assert kc["chunk_start"].tolist() == [0, len(kc["tiles"])]


@pytest.mark.parametrize("per", [0, 1, 2, 5])
@pytest.mark.parametrize("gid,args,sr", CHUNK_GEOMS, ids=CHUNK_IDS)
def test_chunked_emulation_is_bit_equal_to_one_chunk(gid, args, sr, per):
    """Every (row, band) sums the same bins in the same tile and quad order
    whatever the chunking, split K (``per`` tiles a split) included."""
    c = _consts(args, sr)
    kc = dm.prepare_consts(c["w_re"], c["w_im"], c["fb_t"], bf16=True)
    mag = emulate_dft(_frames(16, c["w_re"].shape[0], seed=2), kc, bf16=True)
    chunked = split_mel_step(mag, kc["fb"], kc["chunk_tiles"].tolist(), per)
    one = split_mel_step(mag, kc["fb"], one_chunk_rows(kc), per)
    assert torch.equal(chunked, one)
    assert chunked.abs().max() > 0


@pytest.mark.parametrize("n,chunks,row_tiles,splits", [
    (43, 2, 1, 27), (43, 4, 1, 27), (10 * 128, 2, 10, 7), (66 * 128, 2, 66, 1),
    (21216, 2, 166, 1), (166752, 2, 1303, 1)])
def test_plan_grid_with_mel_chunks(n, chunks, row_tiles, splits):
    """A block owns (row tile, mel chunk): K is split only while those
    blocks leave SMs idle, into ceil(sms / (row tiles x chunks)) runs."""
    rt, sp, per = dm.plan_grid(n, 27, H100_SMS, chunks)
    assert (rt, sp) == (row_tiles, splits)
    assert (sp - 1) * per < 27 <= sp * per
    assert dm.plan_grid(n, 27, H100_SMS) == dm.plan_grid(n, 27, H100_SMS, 1)


def test_mel_chunks_and_the_kernels_int_limits():
    assert [dm.mel_chunks(1000, m) for m in (1, 64, 65, 80, 128, 200)] == [1, 1, 2, 2, 2, 4]
    with pytest.raises(ValueError, match="32-bit"):
        dm.mel_chunks(2 ** 31, 48)
    with pytest.raises(ValueError, match="32-bit"):
        dm.mel_chunks(10, 2 ** 31)
    with pytest.raises(ValueError, match="blocks"):
        dm.mel_chunks(2 ** 24, 2 ** 20)  # 131,072 row tiles x 16,384 chunks


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



@pytest.mark.parametrize("m", [65, 80, 200])
def test_wrapper_takes_any_number_of_mel_bands(m):
    """Over 64 bands the wrapper computes the twin on the CPU and checks its
    inputs as below 64 (on the card it launches the chunked kernel)."""
    rng = np.random.default_rng(1)
    f, wr, wi, fb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((7, 5), (5, 3), (5, 3), (3, m)))
    before = dm.fused_dft_mel.PREPARATIONS, dm.fused_dft_mel.LAUNCHES
    for bf16 in (False, True):
        out = dm.fused_dft_mel(f, wr, wi, fb, bf16=bf16)
        assert out.shape == (7, m)
        assert torch.equal(out, dm.dft_mel_reference(f, wr, wi, fb, bf16=bf16))
    assert (dm.fused_dft_mel.PREPARATIONS, dm.fused_dft_mel.LAUNCHES) == before
    with pytest.raises(ValueError, match="wants frames"):
        dm.fused_dft_mel(f, wr, wi, fb[:2])
    with pytest.raises(ValueError, match="contiguous"):
        dm.fused_dft_mel(f, wr, wi, torch.zeros((m, 3)).t())
    with pytest.raises(TypeError):
        dm.fused_dft_mel(f, wr, wi, fb.double())
