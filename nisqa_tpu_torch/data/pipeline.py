"""Batched inference engine: wav -> mel -> segments -> model, on one device.

Counterpart of ``nisqa_tpu/data/pipeline.py``. ``MsConfig``,
``front_end_consts`` and ``validate_filled_row`` are numpy-only and are
moved here unchanged, because the JAX file imports jax; the tests hold them
equal to the originals. :class:`InferenceEngine` is the JAX engine's cold
pass (``pipeline.py:1033-1221``, interleaved branch) without the corpus
cache, fused cached passes, async fetch, warmup, mesh or filler thread:

  host : header scan -> (sr, transport) groups -> length-sorted batches,
         each padded to a geometric T bucket -> decode + reflect-pad fill
  device: mel_fn (fused DFT->mel kernel) -> seg_fn -> model, per batch
"""

from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nisqa_tpu.audio import wav as wavio
from nisqa_tpu.audio.filters import mel_filterbank, padded_window
from nisqa_tpu.audio.melspec import pad_audio_for_batch
from nisqa_tpu.data import native

from ..ops.dft_mel import fused_dft_mel
from .front_end import frame_geometry, mel_fn, seg_fn


class MsConfig:
    """Mel-spectrogram + segmentation geometry (reference ms_* args)."""

    def __init__(self, args: dict):
        self.sr = args.get("ms_sr")  # None = native rate
        self.fmax = float(args.get("ms_fmax", 20000.0))
        self.n_fft = int(args.get("ms_n_fft", 4096))
        self.hop_s = float(args.get("ms_hop_length", 0.01))
        self.win_s = float(args.get("ms_win_length", 0.02))
        self.n_mels = int(args.get("ms_n_mels", 48))
        self.seg_length = int(args.get("ms_seg_length", 15))
        self.seg_hop = int(args.get("ms_seg_hop_length", 1))
        self.max_segments = int(args.get("ms_max_segments") or 1300)
        self.channel = args.get("ms_channel")
        if self.seg_length % 2 == 0:
            raise ValueError(f"seg_length must be odd! (seg_length={self.seg_length})")

    def buckets(self):
        """Geometric x1.25 length buckets from max/8 up to max_segments."""
        m = self.max_segments
        out = {m}
        b = max(8, math.ceil(m / 8))
        while b < m:
            out.add(b)
            b = math.ceil(b * 1.25)
        return sorted(out)

    def bucket_for(self, n_wins: int) -> int:
        """Smallest grid bucket holding ``n_wins`` segments; over-long files
        get the reference's actionable max-length error."""
        for b in self.buckets():
            if n_wins <= b:
                return b
        raise ValueError(
            f"n_wins {n_wins} > max_length {self.max_segments}. "
            "Increase max window length ms_max_segments!"
        )

    def frames_for_bucket(self, t_bucket: int) -> int:
        return (t_bucket - 1) * self.seg_hop + self.seg_length

    def n_frames(self, n_samples: int, sr: int) -> int:
        return 1 + n_samples // int(sr * self.hop_s)

    def n_wins(self, n_frames: int) -> int:
        full = n_frames - (self.seg_length - 1)
        if full < 1:
            raise ValueError(
                f"Sample too short: {n_frames} frames < seg_length {self.seg_length}"
            )
        return math.ceil(full / self.seg_hop)


def front_end_consts(ms: MsConfig, sr: int, transport: str = "f32"):
    """Host-computed windowed-DFT + mel tensors (numpy float32).

    The window, the librosa 1/32768 PCM16 scaling (transport='i16') and the
    zero-padding of the n_fft frame are folded into the DFT weights; only
    the DFT bins the mel filterbank reads are kept (rounded up to a multiple
    of 128, as in the JAX package, so both compute over the same bins).
    """
    win = int(sr * ms.win_s)
    n_fft = ms.n_fft

    fb = mel_filterbank(int(sr), n_fft, ms.n_mels, 0.0, ms.fmax)  # (M, K)
    nz = np.nonzero(fb.any(axis=0))[0]
    k_hi = int(nz[-1]) + 1 if len(nz) else fb.shape[1]
    k_keep = min(-(-k_hi // 128) * 128, fb.shape[1])

    lpad = (n_fft - win) // 2
    window = padded_window(win, n_fft).astype(np.float64)
    scale = (1.0 / 32768.0) if transport == "i16" else 1.0
    s_idx = lpad + np.arange(win)
    wvals = window[s_idx] * scale
    ang = -2.0 * np.pi * np.outer(s_idx, np.arange(k_keep)) / n_fft
    return {
        "w_re": (wvals[:, None] * np.cos(ang)).astype(np.float32),
        "w_im": (wvals[:, None] * np.sin(ang)).astype(np.float32),
        "fb_t": np.ascontiguousarray(fb[:, :k_keep].T),
    }


def validate_filled_row(ms: MsConfig, path, n, sr, sr_got=None):
    """Post-fill sanity for natively-decoded rows: a file that decodes too
    short for one segment raises the reference's 'Sample too short' error,
    and a sample rate that changed between scan and fill raises too."""
    if sr_got is not None and int(sr_got) != int(sr):
        raise ValueError(
            f"Error loading file {path}: sample rate changed since scan "
            f"({sr_got} != {sr}) — file replaced mid-pass?"
        )
    try:
        ms.n_wins(ms.n_frames(int(n), int(sr)))
    except ValueError as e:
        raise ValueError(f"Error loading file {path}: {e}") from None


def native_decode_available() -> bool:
    """Whether host decode runs in the C++ loader (``native/``, built with
    make at first use) rather than the Python decoder."""
    return native.available()


@contextlib.contextmanager
def matmul_precision(precision: str):
    """'highest': float32 matmuls and convolutions (TF32 off in cuBLAS AND
    cuDNN, which defaults to TF32 for float32 convolutions); 'default':
    TF32 allowed in both. The flags are process-global, so they are set
    around the forward and restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class InferenceEngine:
    """Cold-pass batched predictor over audio paths for one device.

    ``precision``: 'default' (TF32 allowed) or 'highest' (float32).
    ``fe_precision``: 'exact' (float32 DFT) or 'fast' (bf16 DFT operands,
    float32 accumulation); None follows ``precision`` like the JAX engine
    ('exact' under 'highest', else 'fast'). ``dft_mel`` is the DFT->mel
    step; the default launches the CUDA kernel for device tensors.
    """

    def __init__(self, model, ms: MsConfig, device, batch_size: int = 32,
                 num_workers: int = 8, precision: str | None = "default",
                 fe_precision: str | None = None, dft_mel=fused_dft_mel):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.ms = ms
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        self.precision = precision or "default"
        if self.precision not in ("default", "highest"):
            raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
        if fe_precision is None:
            fe_precision = "exact" if self.precision == "highest" else "fast"
        if fe_precision not in ("exact", "fast"):
            raise ValueError(f"fe_precision must be 'exact' or 'fast', got {fe_precision!r}")
        self.fe_precision = fe_precision
        self.dft_mel = dft_mel
        self._consts = {}

    # -- host side -----------------------------------------------------------

    def _load_audio(self, path):
        y, sr = wavio.read_wav(path, channel=self.ms.channel)
        if self.ms.sr:
            y = wavio.resample_kaiser(y, sr, int(self.ms.sr))
            sr = int(self.ms.sr)
        return y, sr

    def _load_audio_transport(self, path):
        """('i16', raw PCM16, sr) for plain 16-bit mono PCM without
        resampling, else ('f32', float samples, sr)."""
        ms = self.ms
        if not ms.sr:
            raw = wavio.read_wav_pcm16_mono(path)
            if raw is not None and len(raw[0]) >= ms.n_fft // 2 + 2:
                return ("i16", raw[0], raw[1])
        y, sr = self._load_audio(path)
        return ("f32", y, sr)

    def _scan_transport(self, paths):
        """Per-file transport descriptors: ('native', n, sr) / ('native_f32',
        n, sr) from the C++ header scan (decoded later in the batch fill), or
        a decoded tuple from :meth:`_load_audio_transport`."""
        ms = self.ms
        out = [None] * len(paths)
        todo = list(range(len(paths)))
        if not ms.sr and native.available() and paths:
            n_s, sr_s, kind_s, status = native.scan_audio(paths, n_threads=self.num_workers)
            min_n = ms.n_fft // 2 + 2
            todo = []
            for i in range(len(paths)):
                if status[i] == 0 and n_s[i] >= min_n:
                    tag = "native" if kind_s[i] == 0 else "native_f32"
                    out[i] = (tag, int(n_s[i]), int(sr_s[i]))
                else:
                    todo.append(i)
        if todo:
            with ThreadPoolExecutor(self.num_workers) as ex:
                for i, v in zip(todo, ex.map(self._load_audio_transport, (paths[i] for i in todo))):
                    out[i] = v
        return out

    def _metas_for(self, audio):
        """Per-file (index, sr, n_wins, transport kind)."""
        metas = []
        for i, (tag, data, sr) in enumerate(audio):
            n = data if tag in ("native", "native_f32") else len(data)
            kind = {"native": "i16", "native_f32": "f32"}.get(tag, tag)
            metas.append((i, sr, self.ms.n_wins(self.ms.n_frames(n, sr)), kind))
        return metas

    def _plan_for(self, metas):
        """[((sr, T bucket, kind), file indices)]: files group by (sr,
        transport), are length-sorted and chunked into batches, and each
        chunk takes the smallest bucket that holds its longest file."""
        bs = self.batch_size
        groups = {}
        for i, sr, nw, kind in metas:
            groups.setdefault((sr, kind), []).append((nw, i))
        plan = []
        for (sr, kind), items in sorted(groups.items()):
            items.sort(key=lambda t: (-t[0], t[1]))
            for start in range(0, len(items), bs):
                chunk = items[start : start + bs]
                plan.append(((sr, self.ms.bucket_for(chunk[0][0]), kind), [i for _, i in chunk]))
        return plan

    def plan(self, paths):
        """The batching plan :meth:`predict_paths` runs for ``paths``."""
        return self._plan_for(self._metas_for(self._scan_transport(list(paths))))

    def _fill(self, chunk, audio, paths, buf_len, kind):
        """Decode + reflect-pad one batch into a (bs, buf_len) host buffer.
        Rows past the chunk are zeros with row 0's length (finite, and
        dropped after the forward)."""
        bs, pad, ms = self.batch_size, self.ms.n_fft // 2, self.ms
        dtype = np.int16 if kind == "i16" else np.float32
        buf = np.zeros((bs, buf_len), dtype)
        n = np.zeros((bs,), np.int32)
        tags = ("native",) if kind == "i16" else ("native", "native_f32")
        native_items = [(j, i) for j, i in enumerate(chunk) if audio[i][0] in tags]
        if native_items:
            target = np.zeros((len(native_items), buf_len), dtype)
            src = [paths[i] for _, i in native_items]
            if kind == "i16":
                ns, srs, status = native.fill_batch_i16(src, target, pad, n_threads=self.num_workers)
            else:
                ns, srs, status = native.fill_batch_f32(
                    src, target, pad, channel=ms.channel, n_threads=self.num_workers)
            for row, (j, i) in enumerate(native_items):
                if status[row] == 0:
                    validate_filled_row(ms, paths[i], ns[row], audio[i][2], srs[row])
                    buf[j], n[j] = target[row], ns[row]
                    continue
                # rare race (file changed since scan): decode in Python below
                x, sr_got = self._load_audio(paths[i])
                validate_filled_row(ms, paths[i], len(x), audio[i][2], sr_got)
                if kind == "i16":
                    x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
                audio[i] = (kind, x, audio[i][2])
        for j, i in enumerate(chunk):
            tag, x = audio[i][0], audio[i][1]
            if tag in ("native", "native_f32"):
                continue
            ln = len(x)
            if kind == "i16":
                buf[j, :pad] = x[pad:0:-1]
                w = min(ln, buf_len - pad)
                buf[j, pad : pad + w] = x[:w]
                take = min(pad, buf_len - (pad + ln))
                if take > 0:
                    buf[j, pad + ln : pad + ln + take] = x[ln - 2 : ln - 2 - take : -1]
            else:
                padded = pad_audio_for_batch(x, ms.n_fft, ln + ms.n_fft)
                w = min(len(padded), buf_len)
                buf[j, :w] = padded[:w]
            n[j] = ln
        n[len(chunk):] = n[0]
        return buf, n

    # -- device side ---------------------------------------------------------

    def _consts_for(self, sr: int, kind: str):
        key = (sr, kind)
        if key not in self._consts:
            self._consts[key] = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in front_end_consts(self.ms, sr, kind).items()
            }
        return self._consts[key]

    def _forward(self, gkey, buf, n):
        sr, bucket, kind = gkey
        audio = torch.from_numpy(buf).to(self.device)
        n_samples = torch.from_numpy(n).to(self.device, dtype=torch.int64)
        db = mel_fn(self.ms, sr, bucket, self._consts_for(sr, kind), audio, n_samples,
                    fast=self.fe_precision == "fast", dft_mel=self.dft_mel)
        return self.model(*seg_fn(self.ms, sr, bucket, db, n_samples))

    def predict_paths(self, paths):
        """Predict for audio paths -> (N, out_dim) float32, in input order."""
        paths = list(paths)
        if not paths:
            return np.zeros((0, 5 if self.model.dim else 1), np.float32)
        audio = self._scan_transport(paths)
        plan = self._plan_for(self._metas_for(audio))
        ys = []
        with torch.inference_mode(), matmul_precision(self.precision):
            for gkey, chunk in plan:
                buf_len = frame_geometry(self.ms, gkey[0], gkey[1])[4]
                buf, n = self._fill(chunk, audio, paths, buf_len, gkey[2])
                ys.append(self._forward(gkey, buf, n)[: len(chunk)])
            all_y = torch.cat(ys).cpu().numpy()  # the pass's one readback
        out = np.zeros((len(paths), all_y.shape[1]), np.float32)
        out[np.concatenate([np.asarray(c) for _, c in plan])] = all_y
        return out
