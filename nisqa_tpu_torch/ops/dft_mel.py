"""Fused windowed-DFT magnitude -> mel projection: CUDA kernel and its twin.

Counterpart of ``nisqa_tpu/ops/pallas_mel.py::fused_dft_mel``:

    mel (N, M) = |frames @ w_re + i * frames @ w_im| @ fb

``fused_dft_mel`` launches the hand-written sm_90a kernel
(``csrc/dft_mel.cu``) for CUDA tensors and uses the plain PyTorch twin
``dft_mel_reference`` only for tensors that lie on the CPU. There is no
fallback from the kernel to the twin on the card: a build or launch failure
raises.

``bf16=True`` is the fast front-end: frames and DFT weights are rounded to
bf16, products and sums stay float32. The twin rounds the same operands the
same way, so kernel and twin differ only in summation order. Exact mode
runs the DFT as 3xTF32 on the tensor cores (``tf32_split``), the
counterpart of the TPU kernel's multi-pass ``Precision.HIGHEST``.

The kernel reads its constants in its own layout, made by
``prepare_consts`` once per constant set (cached on the tensors' identity
and counted in ``fused_dft_mel.PREPARATIONS``), takes the mel bands in
chunks of ``MEL_CHUNK`` (``chunk_tiles``: any M, one chunk up to 64), and
splits the K loop across blocks for small N (``plan_grid``).
"""

from __future__ import annotations

import weakref

import torch

ROWS_PER_BLOCK = 128    # frame rows per block (csrc/dft_mel.cu BM)
BINS_PER_TILE = 64      # DFT bins per K tile (csrc/dft_mel.cu BINS)
SPAN_ALIGN = 64         # w's span padding: one bf16 chunk of 128 bytes
MEL_CHUNK = 64          # mel bands per block: the kernel's shared mel tile (BM, 64)
INT_MAX = 2 ** 31 - 1   # the kernel's row and band indices and its grid's x are 32-bit


def dft_mel_reference(frames, w_re, w_im, fb, bf16: bool = False):
    """Plain PyTorch version: materialises the (N, K) re / im products."""
    if bf16:
        frames, w_re, w_im = (t.to(torch.bfloat16).float() for t in (frames, w_re, w_im))
    return torch.sqrt((frames @ w_re) ** 2 + (frames @ w_im) ** 2) @ fb


def round_tf32(x):
    """float32 -> float32 rounded to TF32 (10 mantissa bits), nearest with
    ties away from zero: ``cvt.rna.tf32.f32`` in integer bit operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x -> (hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi).
    hi*hi' + hi*lo' + lo*hi' is the 3xTF32 product of two such splits."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def band_tiles(fb):
    """fb (Kp, M), Kp a multiple of ``BINS_PER_TILE`` -> int32 (T, 3) rows
    (K tile, m_lo, m_hi): the K tiles whose filterbank rows are nonzero
    somewhere, with the half-open mel band [m_lo, m_hi) they touch."""
    kp, m = fb.shape
    touched = (fb != 0).view(kp // BINS_PER_TILE, BINS_PER_TILE, m).any(dim=1).cpu()
    rows = []
    for t, cols in enumerate(touched):
        nz = torch.nonzero(cols).flatten()
        if len(nz):
            rows.append((t, int(nz[0]), int(nz[-1]) + 1))
    return torch.tensor(rows, dtype=torch.int32).view(-1, 3)


def chunk_tiles(tiles, m: int):
    """Band tiles (T, 3) over M mel bands -> the kernel's chunked plan:
    (int32 (T', 4) rows (K tile, m_lo, m_hi, t), int32 (C + 1,) offsets).

    Chunk c holds bands [64c, min(64c + 64, M)); its rows are
    ``rows[offsets[c]:offsets[c + 1]]``: the tiles whose band meets the
    chunk, in K order, their band clipped to it, and ``t`` each tile's index
    in ``tiles`` (split K partitions ``t``, so a band's partial sums group as
    with one chunk). A chunk that no tile touches has no rows; its columns
    come out zero. Up to 64 bands this is ``tiles`` itself, with t = 0..T-1.
    """
    rows, starts = [], [0]
    for c0 in range(0, m, MEL_CHUNK):
        c1 = min(c0 + MEL_CHUNK, m)
        rows += [(kt, max(lo, c0), min(hi, c1), t)
                 for t, (kt, lo, hi) in enumerate(tiles.tolist()) if lo < c1 and hi > c0]
        starts.append(len(rows))
    return (torch.tensor(rows, dtype=torch.int32).view(-1, 4),
            torch.tensor(starts, dtype=torch.int32))


def prepare_consts(w_re, w_im, fb, bf16: bool):
    """The kernel's layout of the constants, in plain PyTorch.

    * ``w`` (2*Kp, Sp): K-major (one row per output column, contiguous over
      span), re / im interleaved (row 2j = w_re[:, j], row 2j+1 = w_im[:, j]),
      K padded to Kp (a multiple of 64 bins) and span to Sp (a multiple of
      64) with zeros: bf16 in fast mode, the TF32 ``hi`` in exact mode, with
      ``w_lo`` beside it;
    * ``fb`` (Kp, M) float32 with zero rows for the padded bins;
    * ``tiles`` (T, 3) int32 on the host, from :func:`band_tiles` (the
      split planner counts them), and the chunked plan the kernel reads,
      ``chunk_tiles`` (T', 4) / ``chunk_start`` (C + 1,) int32 on the
      device, from :func:`chunk_tiles`.

    Padded bins have zero weights (|0| = 0) and zero filter rows, and skipped
    tiles and bands multiply finite magnitudes by fb's zeros: all exact.
    """
    span, k = w_re.shape
    m = fb.shape[1]
    kp = -(-k // BINS_PER_TILE) * BINS_PER_TILE
    sp = -(-span // SPAN_ALIGN) * SPAN_ALIGN
    w = torch.zeros((kp, 2, sp), dtype=torch.float32, device=w_re.device)
    w[:k, 0, :span] = w_re.t()
    w[:k, 1, :span] = w_im.t()
    w = w.view(2 * kp, sp)
    fb_p = torch.zeros((kp, m), dtype=torch.float32, device=fb.device)
    fb_p[:k] = fb
    tiles = band_tiles(fb_p)
    rows, starts = chunk_tiles(tiles, m)
    out = {"fb": fb_p, "tiles": tiles, "chunk_tiles": rows.to(fb.device),
           "chunk_start": starts.to(fb.device), "k_pad": kp}
    if bf16:
        out["w"] = w.to(torch.bfloat16)
    else:
        out["w"], out["w_lo"] = tf32_split(w)
    return out


def plan_grid(n: int, n_tiles: int, sms: int, chunks: int = 1):
    """(row tiles, splits, tiles per split) of a launch over ``n`` frame
    rows, ``n_tiles`` active K tiles and ``chunks`` mel chunks. A block
    owns (row tile, mel chunk); those blocks alone fill the card from
    ``sms`` up; below that the K tiles are split across
    ``ceil(sms / (row tiles x chunks))`` blocks each (at most one tile a
    split), in contiguous runs of the one-chunk tile list, and the splits
    are summed in order after."""
    row_tiles = -(-n // ROWS_PER_BLOCK)
    blocks = row_tiles * chunks
    splits = 1 if blocks >= sms or n_tiles <= 1 else min(n_tiles, -(-sms // blocks))
    per = -(-n_tiles // splits) if n_tiles else 0
    if per:
        splits = -(-n_tiles // per)  # no empty split
    return row_tiles, splits, per


def mel_chunks(n: int, m: int) -> int:
    """The mel chunks of a launch over ``n`` frame rows and ``m`` bands.
    Raises where the kernel cannot take them: it indexes rows and bands
    with 32-bit ints, and its grid's x (row tiles x chunks) is below 2**31."""
    chunks = -(-m // MEL_CHUNK)
    if n > INT_MAX or m > INT_MAX:
        raise ValueError(f"fused_dft_mel's kernel indexes rows and bands with 32-bit ints: "
                         f"N={n}, M={m} (each must be <= {INT_MAX})")
    if -(-n // ROWS_PER_BLOCK) * chunks > INT_MAX:
        raise ValueError(f"fused_dft_mel's grid would have ceil(N / {ROWS_PER_BLOCK}) x "
                         f"ceil(M / {MEL_CHUNK}) > {INT_MAX} blocks: N={n}, M={m}")
    return chunks


def _check(frames, w_re, w_im, fb, bf16):
    ts = (frames, w_re, w_im, fb)
    frame_types = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if frames.dtype not in frame_types or any(t.dtype != torch.float32 for t in ts[1:]):
        raise TypeError(
            "fused_dft_mel takes float32 tensors (frames may be bfloat16 with bf16=True), "
            f"got {[t.dtype for t in ts]}")
    if any(t.dim() != 2 for t in ts):
        raise ValueError(f"fused_dft_mel takes 2-D tensors, got {[tuple(t.shape) for t in ts]}")
    n, span = frames.shape
    k = w_re.shape[1]
    if n < 1 or w_re.shape != (span, k) or w_im.shape != (span, k) or fb.shape[0] != k:
        raise ValueError(
            "fused_dft_mel wants frames (N>=1, span), w_re/w_im (span, K), fb (K, M); got "
            f"{tuple(frames.shape)}, {tuple(w_re.shape)}, {tuple(w_im.shape)}, {tuple(fb.shape)}"
        )
    if any(t.device != frames.device for t in ts):
        raise ValueError(f"fused_dft_mel inputs on several devices: {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_dft_mel takes contiguous tensors")


_PREPARED = {}  # (id(w_re), id(w_im), id(fb), bf16) -> (weak refs, prepared constants)


def _kernel_consts(w_re, w_im, fb, bf16: bool):
    """``prepare_consts`` once per constant tensors and mode. The entry
    goes when ``w_re`` is freed; the constants are read-only by contract."""
    src = (w_re, w_im, fb)
    key = (*map(id, src), bool(bf16))
    hit = _PREPARED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], src)):
        return hit[1]
    kc = prepare_consts(w_re, w_im, fb, bf16)
    fused_dft_mel.PREPARATIONS += 1
    refs = (weakref.ref(w_re, lambda _, k=key: _PREPARED.pop(k, None)),
            weakref.ref(w_im), weakref.ref(fb))
    _PREPARED[key] = (refs, kc)
    return kc


def fused_dft_mel(frames, w_re, w_im, fb, bf16: bool = False):
    """frames (N, span), w_re / w_im (span, K), fb (K, M), float32 -> (N, M).

    With ``bf16=True`` frames may also come as bfloat16 (the front-end's
    rounding, done once where the frames are made).

    On a CUDA device this launches the kernel on the current stream, does
    not synchronise, and counts the launch in ``fused_dft_mel.LAUNCHES``.
    On the CPU it computes ``dft_mel_reference`` and counts nothing.
    """
    _check(frames, w_re, w_im, fb, bf16)
    if frames.device.type == "cpu":
        return dft_mel_reference(frames, w_re, w_im, fb, bf16)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_dft_mel runs on cuda or cpu tensors, got {frames.device}")
    n, span = frames.shape
    k, m = fb.shape
    chunks = mel_chunks(n, m)

    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(frames.device):
        kc = _kernel_consts(w_re, w_im, fb, bf16)
        frames = frames.to(torch.bfloat16 if bf16 else torch.float32)
        ld = span
        if (span * frames.element_size()) % 16 or frames.data_ptr() % 16:
            # TMA wants 16-byte aligned rows: copy into a zero-padded buffer
            ld = -(-span * frames.element_size() // 16) * 16 // frames.element_size()
            padded = torch.zeros((n, ld), dtype=frames.dtype, device=frames.device)
            padded[:, :span] = frames
            frames = padded
        n_tiles = kc["tiles"].shape[0]
        sms = torch.cuda.get_device_properties(frames.device).multi_processor_count
        _, splits, per = plan_grid(n, n_tiles, sms, chunks)
        out = torch.empty((n, m), dtype=torch.float32, device=frames.device)
        scratch = (torch.empty((splits, n, m), dtype=torch.float32, device=frames.device)
                   if splits > 1 else None)
        w_lo = kc.get("w_lo")
        code = lib.nisqa_dft_mel(
            frames.data_ptr(), ld, kc["w"].data_ptr(), w_lo.data_ptr() if w_lo is not None else None,
            kc["w"].shape[1], kc["chunk_tiles"].data_ptr(), kc["chunk_start"].data_ptr(), chunks,
            per, splits, kc["fb"].data_ptr(),
            out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            n, span, kc["k_pad"], m, int(not bf16),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    if code != 0:
        msg = lib.nisqa_cuda_error_string(code).decode()
        raise RuntimeError(
            f"dft_mel kernel launch failed: error {code} ({msg}) for "
            f"N={n} span={span} K={k} M={m} bf16={bool(bf16)} splits={splits}"
        )
    fused_dft_mel.LAUNCHES += 1
    return out


fused_dft_mel.LAUNCHES = 0
fused_dft_mel.PREPARATIONS = 0
