"""FLAC decoding (and a minimal encoder for fixtures) without third-party libs.

The reference front door accepts anything librosa/soundfile can decode
(`nisqa/NISQA_lib.py:2298-2306`), which in speech corpora
means WAV and FLAC almost exclusively. This module implements the FLAC
format from the public spec (RFC 9639): metadata blocks, fixed-blocksize and
variable-blocksize frames, all subframe types (CONSTANT / VERBATIM / FIXED
0-4 / LPC 1-32), Rice / Rice2 partitioned residuals with escape codes,
wasted bits, and the four stereo decorrelation modes (independent,
left-side, right-side, mid-side). Output matches soundfile/librosa:
int PCM divided by 2**(bits-1), channel-mean *after* float conversion.

A C++ decode path (native/wavloader.cpp) covers the serving throughput
case; this numpy/Python implementation is the reference and fallback.

The port's copy of ``nisqa_tpu/audio/flac.py`` (same functions, same names), so the
port imports nothing of the JAX package; tests hold the two equal.
"""

from __future__ import annotations

import struct

import numpy as np


class FlacFormatError(ValueError):
    pass


# fixed-predictor coefficients by order (RFC 9639 §9.2.2)
_FIXED_COEF = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCKSIZE_CODE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}

_SAMPLE_RATE_CODE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}

_SAMPLE_SIZE_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _BitReader:
    """MSB-first bit reader over bytes; fast paths for unary + n-bit reads."""

    def __init__(self, data, pos=0):
        self.data = data
        self.byte = pos  # next unread byte
        self.acc = 0     # LSB-aligned window of already-pulled bits
        self.nbits = 0   # number of valid bits in acc

    def _pull(self):
        try:
            b = self.data[self.byte]
        except IndexError:
            raise FlacFormatError("unexpected end of FLAC stream")
        self.byte += 1
        self.acc = (self.acc << 8) | b
        self.nbits += 8

    def read_uint(self, n):
        while self.nbits < n:
            self._pull()
        self.nbits -= n
        r = self.acc >> self.nbits
        self.acc &= (1 << self.nbits) - 1
        return r

    def read_sint(self, n):
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self):
        q = 0
        while True:
            if self.nbits == 0:
                self._pull()
            if self.acc == 0:
                q += self.nbits
                self.nbits = 0
                continue
            top = self.acc.bit_length()
            q += self.nbits - top
            self.nbits = top - 1
            self.acc &= (1 << self.nbits) - 1
            return q

    def align(self):
        drop = self.nbits & 7
        if drop:
            self.read_uint(drop)

    def at_byte(self):
        """Current position in bytes (requires byte alignment)."""
        return self.byte - self.nbits // 8

    def read_utf8_number(self):
        """FLAC's UTF-8-style coded frame/sample number (up to 36 bits)."""
        b0 = self.read_uint(8)
        if b0 < 0x80:
            return b0
        n_follow = 0
        mask = 0x40
        while b0 & mask:
            n_follow += 1
            mask >>= 1
        if n_follow < 1 or n_follow > 6:
            raise FlacFormatError("invalid coded number in frame header")
        v = b0 & (mask - 1)
        for _ in range(n_follow):
            b = self.read_uint(8)
            if (b & 0xC0) != 0x80:
                raise FlacFormatError("invalid coded number continuation byte")
            v = (v << 6) | (b & 0x3F)
        return v


def _decode_residual(br, blocksize, order):
    """Partitioned Rice residual -> int64 array of blocksize - order values."""
    method = br.read_uint(2)
    if method > 1:
        raise FlacFormatError(f"reserved residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read_uint(4)
    n_part = 1 << po
    # blocksize must split evenly and the first partition must still have
    # room after the warmup samples (RFC 9639 §9.2.7)
    if blocksize % n_part or (blocksize >> po) < order:
        raise FlacFormatError("invalid rice partition order")
    out = np.empty(blocksize - order, np.int64)
    pos = 0
    for p in range(n_part):
        n = (blocksize >> po) - (order if p == 0 else 0)
        k = br.read_uint(plen)
        if k == escape:
            nb = br.read_uint(5)
            if nb == 0:
                out[pos : pos + n] = 0
            else:
                for i in range(n):
                    out[pos + i] = br.read_sint(nb)
        elif k == 0:
            for i in range(n):
                q = br.read_unary()
                out[pos + i] = (q >> 1) ^ -(q & 1)
        else:
            read_unary = br.read_unary
            read_uint = br.read_uint
            for i in range(n):
                v = (read_unary() << k) | read_uint(k)
                out[pos + i] = (v >> 1) ^ -(v & 1)
        pos += n
    return out


def _restore_fixed(warmup, res, order):
    """Invert the order-th finite difference (vectorised cumsums)."""
    if order == 0:
        return res
    w = np.asarray(warmup, np.int64)
    diffs = [w]
    for _ in range(order - 1):
        diffs.append(np.diff(diffs[-1]))
    cur = res
    for j in range(order - 1, -1, -1):
        cur = np.cumsum(cur) + diffs[j][-1]
    return np.concatenate([w, cur])


def _restore_lpc(warmup, res, coefs, shift):
    n = len(warmup) + len(res)
    order = len(coefs)
    x = [0] * n
    x[:order] = [int(v) for v in warmup]
    c = [int(v) for v in coefs]  # c[0] applies to x[i-1]
    r = [int(v) for v in res]
    for i in range(order, n):
        acc = 0
        for j in range(order):
            acc += c[j] * x[i - 1 - j]
        x[i] = r[i - order] + (acc >> shift)
    return np.asarray(x, np.int64)


def _decode_subframe(br, blocksize, bps):
    if br.read_uint(1):
        raise FlacFormatError("subframe padding bit set")
    t = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
    bps -= wasted

    if t == 0:  # CONSTANT
        x = np.full(blocksize, br.read_sint(bps), np.int64)
    elif t == 1:  # VERBATIM
        x = np.fromiter((br.read_sint(bps) for _ in range(blocksize)),
                        np.int64, blocksize)
    elif 8 <= t <= 12:  # FIXED, order t-8
        order = t - 8
        warmup = [br.read_sint(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        x = _restore_fixed(warmup, res, order)
    elif t >= 32:  # LPC, order (t & 31) + 1
        order = (t & 31) + 1
        warmup = [br.read_sint(bps) for _ in range(order)]
        prec = br.read_uint(4) + 1
        if prec == 16:
            raise FlacFormatError("invalid LPC precision escape")
        shift = br.read_sint(5)
        if shift < 0:
            raise FlacFormatError("negative LPC shift")
        coefs = [br.read_sint(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        x = _restore_lpc(warmup, res, coefs, shift)
    else:
        raise FlacFormatError(f"reserved subframe type {t}")
    if wasted:
        x = x << wasted
    return x


def parse_streaminfo(data: bytes):
    """Walk the metadata blocks -> (sample_rate, channels, bits, total_samples,
    first_frame_offset). Cheap (header-only) — used to reject non-16-bit-mono
    streams before paying for a full decode."""
    if data[:4] != b"fLaC":
        raise FlacFormatError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    streaminfo = None
    while True:
        if pos + 4 > len(data):
            raise FlacFormatError("truncated FLAC metadata")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if hdr & 0x7F == 0:  # STREAMINFO
            if length < 34:
                raise FlacFormatError("short STREAMINFO block")
            sr = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
            channels = ((body[12] >> 1) & 0x7) + 1
            bits = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            total = ((body[13] & 0x0F) << 32) | int.from_bytes(body[14:18], "big")
            streaminfo = (sr, channels, bits, total)
        pos += 4 + length
        if hdr & 0x80:
            break
    if streaminfo is None:
        raise FlacFormatError("missing STREAMINFO block")
    return streaminfo + (pos,)


def decode_flac(data: bytes):
    """Decode a FLAC stream -> (pcm int32 (n, channels), sample_rate, bits)."""
    sr0, n_ch0, bits0, total, pos = parse_streaminfo(data)

    chunks = []
    n_done = 0
    while pos < len(data):
        br = _BitReader(data, pos)
        try:
            sync = br.read_uint(14)
        except FlacFormatError:
            if total and n_done < total:
                raise  # declared-length stream truncated mid-frame
            break
        if sync != 0x3FFE:
            if total == 0 and chunks:
                break  # unknown-length stream: trailing non-frame bytes
            raise FlacFormatError(f"bad frame sync at byte {pos}")
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        ss_code = br.read_uint(3)
        br.read_uint(1)  # reserved
        br.read_utf8_number()
        if bs_code == 0:
            raise FlacFormatError("reserved blocksize code 0")
        elif bs_code == 6:
            blocksize = br.read_uint(8) + 1
        elif bs_code == 7:
            blocksize = br.read_uint(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODE[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        elif sr_code == 15:
            raise FlacFormatError("invalid sample rate code")
        bits = bits0 if ss_code == 0 else _SAMPLE_SIZE_CODE.get(ss_code)
        if bits is None:
            raise FlacFormatError(f"reserved sample size code {ss_code}")
        br.read_uint(8)  # CRC-8 (not verified)

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, blocksize, bits) for _ in range(n_ch)]
            block = np.stack(subs, axis=1)
        elif ch_code in (8, 9, 10):
            # side channel carries one extra bit
            if ch_code == 8:  # left-side
                left = _decode_subframe(br, blocksize, bits)
                side = _decode_subframe(br, blocksize, bits + 1)
                right = left - side
                block = np.stack([left, right], axis=1)
            elif ch_code == 9:  # right-side
                side = _decode_subframe(br, blocksize, bits + 1)
                right = _decode_subframe(br, blocksize, bits)
                block = np.stack([side + right, right], axis=1)
            else:  # mid-side
                mid = _decode_subframe(br, blocksize, bits)
                side = _decode_subframe(br, blocksize, bits + 1)
                left = (2 * mid + (side & 1) + side) >> 1
                block = np.stack([left, left - side], axis=1)
        else:
            raise FlacFormatError(f"reserved channel assignment {ch_code}")

        br.align()
        pos = br.at_byte() + 2  # skip CRC-16 (not verified)
        chunks.append(block)
        n_done += blocksize
        if total and n_done >= total:
            break

    if not chunks:
        raise FlacFormatError("FLAC stream contains no audio frames")
    pcm = np.concatenate(chunks, axis=0)
    if total:
        pcm = pcm[:total]
    return pcm.astype(np.int32), sr0, bits0


def read_flac(path: str, channel: int | None = None, mono: bool = True):
    """Read a FLAC file -> (float32 samples, sample_rate), librosa semantics
    (divide by 2**(bits-1); channel select or channel mean in float)."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr, bits = decode_flac(data)
    x = pcm.astype(np.float32) / float(1 << (bits - 1))
    if x.shape[1] > 1:
        if channel is not None:
            x = x[:, channel]
        elif mono:
            x = x.mean(axis=1)
        else:
            x = x.T  # (C, N) like wav.read_wav(mono=False)
    else:
        x = x[:, 0]
    return np.ascontiguousarray(x, np.float32), sr


def read_flac_pcm16_mono(path: str):
    """Fast-path analog of wav.read_wav_pcm16_mono: exact int16 samples for
    16-bit mono FLAC, or None (caller falls back to read_flac)."""
    with open(path, "rb") as f:
        data = f.read()
    # header-only gate: don't pay for a full decode just to discover the
    # stream is stereo/24-bit and decode it AGAIN in the float fallback
    _, channels, bits, _, _ = parse_streaminfo(data)
    if bits != 16 or channels != 1:
        return None
    pcm, sr, _ = decode_flac(data)
    return pcm[:, 0].astype(np.int16), sr


# ---------------------------------------------------------------------------
# Minimal encoder (tests/fixtures only — the framework never writes FLAC)
# ---------------------------------------------------------------------------


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v, n):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self):
        assert self.nbits == 0
        return bytes(self.out)


def _utf8_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    out = []
    n_follow = 1
    while v >= (1 << (6 * n_follow + (6 - n_follow))):
        n_follow += 1
    head_bits = 6 - n_follow
    out.append((0xFF << (head_bits + 1)) & 0xFF | (v >> (6 * n_follow)))
    for i in range(n_follow - 1, -1, -1):
        out.append(0x80 | ((v >> (6 * i)) & 0x3F))
    return bytes(out)


def _quantized_lpc(x, order, precision=14):
    """Autocorrelation + Levinson-Durbin -> quantized integer coefficients."""
    xf = x.astype(np.float64)
    ac = np.array([np.dot(xf[: len(xf) - i], xf[i:]) for i in range(order + 1)])
    if ac[0] == 0:
        return None
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[1 : i + 1][::-1])
        kref = acc / err
        a[: i + 1] = np.concatenate([a[:i] - kref * a[:i][::-1], [kref]])
        err *= 1.0 - kref * kref
        if err <= 0:
            return None
    cmax = np.abs(a).max()
    if cmax == 0:
        return None
    shift = min(15, max(1, int(precision - 1 - np.ceil(np.log2(cmax + 1e-9)))))
    q = np.clip(np.round(a * (1 << shift)), -(1 << (precision - 1)),
                (1 << (precision - 1)) - 1).astype(np.int64)
    return q, shift, precision


def _write_residual(bw, res, partition_order, blocksize, pred_order, escape=False):
    bw.write(0, 2)                    # method 0 (4-bit rice)
    bw.write(partition_order, 4)
    n_part = 1 << partition_order
    pos = 0
    for p in range(n_part):
        n = (blocksize >> partition_order) - (pred_order if p == 0 else 0)
        part = res[pos : pos + n]
        pos += n
        if escape:
            nb = max(2, int(np.abs(part).max()).bit_length() + 1) if len(part) else 2
            bw.write(15, 4)           # escape code
            bw.write(nb, 5)
            for v in part:
                bw.write(int(v), nb)
            continue
        mean = max(1.0, float(np.abs(part).mean()) if len(part) else 1.0)
        k = min(14, max(0, int(np.ceil(np.log2(mean + 1)))))
        bw.write(k, 4)
        for v in part:
            v = int(v)
            u = (v << 1) ^ (v >> 63)  # zigzag
            bw.write_unary(u >> k)
            if k:
                bw.write(u & ((1 << k) - 1), k)


def _write_subframe(bw, x, bps, predictor="fixed", partition_order=0,
                    escape=False):
    """Encode one channel block. ``predictor``: 'fixed' (best order 0-2) |
    'lpc' (order-8 Levinson-Durbin) | 'verbatim'. Wasted bits are detected
    so every decoder path is exercisable from tests."""
    blocksize = len(x)
    # wasted-bits detection: LSBs zero across the whole block
    wasted = 0
    if np.any(x):
        ors = int(np.bitwise_or.reduce(x.astype(np.int64)))
        wasted = min(8, (ors & -ors).bit_length() - 1)
    if wasted:
        x = x >> wasted
        bps -= wasted

    def header(subframe_type):
        bw.write(0, 1)
        bw.write(subframe_type, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    lpc = None
    if predictor == "lpc" and blocksize > 32:
        order = 8
        lpc = _quantized_lpc(x, order)
    if lpc is not None:
        q, shift, precision = lpc
        order = len(q)
        header(32 | (order - 1))
        for i in range(order):
            bw.write(int(x[i]), bps)
        bw.write(precision - 1, 4)
        bw.write(shift, 5)
        for c in q:
            bw.write(int(c), precision)
        # exact integer residual, matching the decoder's arithmetic
        xi = x.astype(np.int64)
        pred = np.zeros(blocksize - order, np.int64)
        for j in range(order):
            pred += q[j] * xi[order - 1 - j : blocksize - 1 - j]
        res = xi[order:] - (pred >> shift)
        _write_residual(bw, res, partition_order, blocksize, order, escape)
        return

    if predictor == "verbatim" or blocksize <= 2:
        header(1)
        for v in x:
            bw.write(int(v), bps)
        return

    best = None
    for order, coef in ((0, []), (1, [1]), (2, [2, -1])):
        if blocksize <= order or (partition_order and (blocksize >> partition_order) < order):
            continue
        res = x[order:].astype(np.int64)
        for j, c in enumerate(coef):
            res = res - c * x[order - 1 - j : blocksize - 1 - j]
        cost = int(np.abs(res).sum())
        if best is None or cost < best[2]:
            best = (order, res, cost)
    order, res, _ = best
    header(8 + order)
    for i in range(order):
        bw.write(int(x[i]), bps)
    _write_residual(bw, res, partition_order, blocksize, order, escape)


def write_flac(path: str, x: np.ndarray, sample_rate: int, mode: str = "indep",
               blocksize: int = 4096, predictor: str = "fixed",
               partition_order: int = 0, escape: bool = False):
    """Write float [-1,1] (n,) or (n, 2) samples as 16-bit FLAC.

    ``mode`` (stereo only): 'indep' | 'left-side' | 'right-side' | 'mid-side';
    ``predictor``: 'fixed' | 'lpc' | 'verbatim'; ``partition_order`` /
    ``escape`` select the residual layout — together these exercise every
    subframe/residual decode path in tests.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n, n_ch = x.shape
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int64)

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(n_ch - 1, 3)
    si.write(15, 5)  # bits - 1
    si.write(n, 36)
    body = si.bytes() + b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    ch_code = {"indep": n_ch - 1, "left-side": 8, "right-side": 9, "mid-side": 10}[
        mode if n_ch == 2 else "indep"
    ]
    for fi, start in enumerate(range(0, n, blocksize)):
        block = pcm[start : start + blocksize]
        bs = len(block)
        hw = _BitWriter()
        hw.write(0x3FFE, 14)
        hw.write(0, 1)
        hw.write(0, 1)  # fixed blocksize
        hw.write(7, 4)  # 16-bit blocksize-1 follows
        hw.write(0, 4)  # sample rate from STREAMINFO
        hw.write(ch_code, 4)
        hw.write(4, 3)  # 16-bit samples
        hw.write(0, 1)
        hw.align()
        header = hw.bytes() + _utf8_number(fi) + struct.pack(">H", bs - 1)
        header += bytes([_crc8(header)])

        fw = _BitWriter()
        # a ragged tail block may not split into 2^po equal partitions
        po_f = partition_order if bs % (1 << partition_order) == 0 else 0
        wsf = lambda ch, bps: _write_subframe(fw, ch, bps, predictor, po_f, escape)
        if ch_code < 8:
            for c in range(n_ch):
                wsf(block[:, c], 16)
        else:
            left, right = block[:, 0], block[:, 1]
            side = left - right
            if ch_code == 8:
                wsf(left, 16)
                wsf(side, 17)
            elif ch_code == 9:
                wsf(side, 17)
                wsf(right, 16)
            else:
                wsf((left + right) >> 1, 16)
                wsf(side, 17)
        fw.align()
        frame = header + fw.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame

    with open(path, "wb") as f:
        f.write(bytes(out))
