"""Batched inference engine: wav -> mel -> segments -> model, on one device.

Counterpart of ``nisqa_tpu/data/pipeline.py``. ``MsConfig``,
``front_end_consts``, ``validate_filled_row`` and ``_resident_split`` are
numpy-only and are moved here unchanged, because the JAX file imports jax;
the tests hold them equal to the originals. :class:`InferenceEngine` keeps
the JAX engine's method names for its serving regimes, for single-ended and
double-ended models (``stats["last"]["mode"]`` names the regime):

  interleaved (cold pass):
    host  : header scan -> (sr, transport) groups -> length-sorted batches,
            each padded to a geometric T bucket
    filler: one background thread decodes + reflect-pads batch j+1 into a
            pinned staging slot (a ring of ``RING_SLOTS`` per transport)
            while the main thread copies and runs batch j
    device: copy stream: pinned slot -> device (non_blocking); compute
            stream, after the copy's event: mel stage (``mel_fn``, the fused
            DFT->mel kernel) -> seg+model stage (``seg_fn`` -> model)
    cache : each batch's mel dB and n stay on the device, keyed by the
            corpus's (path, size, mtime_ns), LRU under ``cache_mb``
    double-ended (NISQA_DE, ``paths_ref``): a batch holds both ends of its
            pairs at one length (the longer end's bucket) and one transport
            (f32 when either end is); each end has its own staging ring,
            upload, mel stage (two kernel launches per cold batch), seg_fn
            and cached mel block, and the model takes the two ends apart
            (``forward_ends``)
  cached: seg+model over the resident mel blocks (no decode, no upload, no
          front-end); runs of same-shape blocks are concatenated on the
          device once and run as one (k*bs) batch ("fused" parts)
  cached_partial: a corpus over ``cache_mb`` keeps the batches that fit
          resident; the cold tail is re-scanned and re-filled every pass

Every regime ends in one device->host readback per pass (``fetch``).

Data parallel (``mesh``, a :class:`..parallel.mesh.DataParallel`): every
rank scans and plans the whole list (the plan is deterministic) and runs
the batches ``plan[rank::W]`` through the regimes above; the (N, K) result
is assembled on every rank by one SUM all-reduce of the rows each rank
computed. ``nisqa_tpu`` splits the rows of every batch over its mesh
instead; in eval rows do not interact, so each rank runs whole batches at
the single-device shapes and every prediction equals the single-device
one. ``stats`` and the corpus cache are per rank.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures

import numpy as np
import torch

from ..audio import wav as wavio
from ..audio.filters import mel_filterbank, padded_window
from ..audio.melspec import pad_audio_for_batch
from ..ops.dft_mel import fused_dft_mel
from ..parallel.mesh import sum_rows
from . import native
from .front_end import frame_geometry, mel_fn, seg_fn

# Cached passes over plans of at most FUSE_WHOLE_MAX batches keep their mel
# blocks in one flat device tensor (mode "mel_fused"); bigger plans keep one
# concatenated block per part (mode "mel_fused_parts"). Both run the parts of
# _fuse_plan_chunks. The names and the NISQA_FUSE_WHOLE_MAX knob follow the
# JAX engine; outputs are the same either way.
FUSE_WHOLE_MAX = int(os.environ.get("NISQA_FUSE_WHOLE_MAX", "32"))
# per-part working-set budget (segment tensor + attention score estimate, bytes)
_FUSE_CHUNK_BYTES = 512 * (1 << 20)
# pinned staging slots per transport: the filler runs at most this many
# batches of one transport ahead of the copies
RING_SLOTS = 3


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


def _resident_split(items, bytes_of, cap):
    """The partial-caching greedy, shared by the cold pass's store (actual
    nbytes) and warmup's mirror (byte estimates): walk ``items`` in plan
    order, keep every item whose bytes still fit under ``cap`` resident; the
    rest go cold. Not prefix-only: a too-big batch is skipped but later
    smaller ones may still fit."""
    resident, cold, used = [], [], 0
    for it in items:
        b = bytes_of(it)
        if used + b <= cap:
            resident.append(it)
            used += b
        else:
            cold.append(it)
    return resident, cold, used


def native_decode_available() -> bool:
    """Whether host decode runs in the C++ loader (``native/wavloader.cpp``,
    built with g++ at first use into ``_build/``) rather than in Python."""
    return native.available()


@contextlib.contextmanager
def matmul_precision(precision: str):
    """'highest': float32 matmuls and convolutions (TF32 off in cuBLAS AND
    cuDNN, which defaults to TF32 for float32 convolutions); 'default':
    TF32 allowed in both. The flags are process-global, so they are set
    around a pass's dispatches and restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Slot:
    """One host staging buffer of the ring: pinned on a CUDA engine.

    The filler takes the slot (:meth:`acquire`) before it fills it; the main
    thread gives it back (:meth:`release`) with the CUDA event recorded after
    the host->device copy that reads it. The next :meth:`acquire` waits for
    that event, so a slot is never refilled while its copy is in flight.
    ``buf`` is flat and grows to the largest batch it has held (pinned
    allocation is slow, so it is done once per size, not per batch).
    """

    def __init__(self, dtype, bs: int, pin: bool):
        self.dtype, self.bs, self.pin = dtype, bs, pin
        self.buf = None
        self.n = torch.empty((bs,), dtype=torch.int32, pin_memory=pin)
        self.copied = None
        self._free = threading.Event()
        self._free.set()

    def acquire(self, buf_len: int):
        """Wait until the slot is free and its last copy is done; returns
        (buf (bs, buf_len), n (bs,)) numpy views of the pinned memory."""
        self._free.wait()
        self._free.clear()
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        numel = self.bs * buf_len
        if self.buf is None or self.buf.numel() < numel:
            self.buf = None
            self.buf = torch.empty((numel,), dtype=self.dtype, pin_memory=self.pin)
        return self.buf[:numel].numpy().reshape(self.bs, buf_len), self.n.numpy()

    def rows(self, buf_len: int):
        return self.buf[: self.bs * buf_len].view(self.bs, buf_len)

    def release(self, event=None):
        if event is not None:
            self.copied = event
        self._free.set()


class InferenceEngine:
    """Batched predictor over audio paths for one device.

    ``precision``: 'default' (TF32 allowed) or 'highest' (float32); None
    means 'default'. Models with an LSTM time dependency (``td`` or
    ``td_2``) upgrade None and 'default' to 'highest', as the JAX engine
    does: the recurrence over thousands of steps amplifies TF32 rounding.
    ``fe_precision``: 'exact' (float32 DFT) or 'fast' (bf16 DFT operands,
    float32 accumulation); None follows ``precision`` like the JAX engine
    ('exact' under 'highest', else 'fast'). ``dft_mel`` is the DFT->mel
    step; the default launches the CUDA kernel for device tensors.
    ``fuse_pass``: None/True concatenate same-shape resident mel blocks for
    cached passes; False runs cached passes batch by batch. ``cache_mb``:
    device budget of the corpus mel cache (0 turns it off). ``mesh``: the
    rank's :class:`..parallel.mesh.DataParallel` record (None: this process
    alone); every rank of its group must make the same calls.
    """

    def __init__(self, model, ms: MsConfig, device, batch_size: int = 32,
                 num_workers: int = 8, precision: str | None = "default",
                 fe_precision: str | None = None, dft_mel=fused_dft_mel,
                 fuse_pass: bool | None = None, cache_mb: float = 512, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.ms = ms
        self.batch_size = int(batch_size)
        self.num_workers = max(1, int(num_workers))
        if precision in (None, "default") and "lstm" in (
            model.cfg.get("td") or "", model.cfg.get("td_2") or ""
        ):
            precision = "highest"
        self.precision = precision or "default"
        if self.precision not in ("default", "highest"):
            raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
        if fe_precision is None:
            fe_precision = "exact" if self.precision == "highest" else "fast"
        if fe_precision not in ("exact", "fast"):
            raise ValueError(f"fe_precision must be 'exact' or 'fast', got {fe_precision!r}")
        self.fe_precision = fe_precision
        self.dft_mel = dft_mel
        self.fuse_pass = fuse_pass
        self.cache_mb = float(cache_mb)
        self._corpus_cache = {}  # fingerprint -> entry, in LRU order
        self._cache_bytes = 0
        self.stats = {"passes": 0, "files": 0, "cache_hits": 0, "last": None}
        self._consts = {}
        self._rings = {}  # transport, or (transport, "ref") -> [_Slot] * RING_SLOTS
        self._ring_next = {}
        self._fill_ex = None
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None

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

    def _metas_for(self, audio, audio_ref=None):
        """Per-file (index, sr, n_wins, transport kind). A double-ended pair
        takes the larger n_wins of its two ends and the f32 transport when
        either end needs it; its ends must share a sample rate."""
        ms = self.ms

        def n_wins_kind(entry):
            tag, data, sr = entry
            n = data if tag in ("native", "native_f32") else len(data)
            return ms.n_wins(ms.n_frames(n, sr)), {"native": "i16", "native_f32": "f32"}.get(tag, tag)

        metas = []
        for i, entry in enumerate(audio):
            sr = entry[2]
            nw, kind = n_wins_kind(entry)
            if audio_ref is not None:
                ref = audio_ref[i]
                if ref[2] != sr:
                    raise ValueError(f"deg/ref sample rates differ for item {i}: {sr} != {ref[2]}")
                nw_r, kind_r = n_wins_kind(ref)
                nw = max(nw, nw_r)
                kind = "f32" if "f32" in (kind, kind_r) else "i16"
            metas.append((i, sr, nw, kind))
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

    def _check_ref(self, paths, paths_ref):
        """``paths_ref`` as a list for a double-ended model, else None;
        raises when it is missing, of another length, or given to a
        single-ended model."""
        if not self.model.double_ended:
            if paths_ref is not None:
                raise ValueError(f"paths_ref is for double-ended models; {self.model.name} "
                                 "is single-ended")
            return None
        if paths_ref is None:
            raise ValueError("NISQA_DE needs paths_ref: one reference file per degraded file")
        paths_ref = list(paths_ref)
        if len(paths_ref) != len(paths):
            raise ValueError(f"paths_ref has {len(paths_ref)} files for {len(paths)} degraded files")
        return paths_ref

    def _scan_plan(self, paths, paths_ref):
        """(degraded-end audio, reference-end audio or None, plan); under a
        mesh the plan is the rank's share, ``plan[rank::W]``."""
        audio = self._scan_transport(paths)
        audio_ref = self._scan_transport(paths_ref) if paths_ref is not None else None
        plan = self._plan_for(self._metas_for(audio, audio_ref))
        if self.mesh is not None:
            plan = plan[self.mesh.rank :: self.mesh.size]
        return audio, audio_ref, plan

    def plan(self, paths, paths_ref=None):
        """The batching plan :meth:`predict_paths` runs for ``paths`` (on
        this rank, under a mesh)."""
        paths = list(paths)
        return self._scan_plan(paths, self._check_ref(paths, paths_ref))[2]

    def _ends(self) -> int:
        return 2 if self.model.double_ended else 1

    def _host_buf(self, kind: str, end: int = 0) -> _Slot:
        """The next staging slot of the ring of ``kind`` and ``end`` (0 the
        degraded end, 1 the reference; taken in plan order by the main
        thread, filled in the same order by the filler)."""
        key = (kind, "ref") if end else kind
        ring = self._rings.get(key)
        if ring is None:
            dtype = torch.int16 if kind == "i16" else torch.float32
            ring = self._rings[key] = [_Slot(dtype, self.batch_size, self._cuda)
                                       for _ in range(RING_SLOTS)]
            self._ring_next[key] = 0
        j = self._ring_next[key]
        self._ring_next[key] = (j + 1) % RING_SLOTS
        return ring[j]

    def _make_batch(self, slot: _Slot, chunk, audio, paths, buf_len, kind, n_threads=None):
        """Decode + reflect-pad one batch into ``slot`` (runs on the filler
        thread) with ``n_threads`` decode threads (None: ``num_workers``).
        Rows past the chunk take row 0's length (finite, dropped after the
        forward)."""
        pad, ms = self.ms.n_fft // 2, self.ms
        n_threads = n_threads or self.num_workers
        buf, n = slot.acquire(buf_len)
        if kind == "i16":
            # raw PCM16 transport: [left reflect][samples][right reflect]
            # [bounded garbage]. No zeroing: int16 garbage is bounded, gives
            # finite mels, and every garbage frame/segment is masked
            # downstream by n_frames/n_wins.
            tags = ("native",)
        else:
            buf.fill(0)
            tags = ("native", "native_f32")
        native_items = [(j, i) for j, i in enumerate(chunk) if audio[i][0] in tags]
        if native_items:
            # C++ decode + reflect-pad fill, threaded, GIL-free. When the
            # whole chunk is native (the common case) fill the batch rows in
            # place; otherwise use a scratch block.
            all_native = len(native_items) == len(chunk)
            dtype = np.int16 if kind == "i16" else np.float32
            target = buf[: len(chunk)] if all_native else np.zeros(
                (len(native_items), buf_len), dtype)
            src = [paths[i] for _, i in native_items]
            if kind == "i16":
                ns, srs, status = native.fill_batch_i16(src, target, pad, n_threads=n_threads)
            else:
                ns, srs, status = native.fill_batch_f32(
                    src, target, pad, channel=ms.channel, n_threads=n_threads)
            for row, (j, i) in enumerate(native_items):
                if status[row] == 0:
                    validate_filled_row(ms, paths[i], ns[row], audio[i][2], srs[row])
                    if not all_native:
                        buf[j] = target[row]
                    n[j] = ns[row]
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
                # under seg_hop subsampling a file's ceil-remainder tail may
                # extend past the bucket's read span: clamp to the buffer; n
                # keeps the true count so device masks match the plan
                w = min(ln, buf_len - pad)
                buf[j, pad : pad + w] = x[:w]
                take = min(pad, buf_len - (pad + ln))
                if take > 0:
                    buf[j, pad + ln : pad + ln + take] = x[ln - 2 : ln - 2 - take : -1]
            else:
                if tag == "i16":
                    x = x.astype(np.float32) / 32768.0
                padded = pad_audio_for_batch(x, ms.n_fft, ln + ms.n_fft)
                w = min(len(padded), buf_len)
                buf[j, :w] = padded[:w]
            n[j] = ln
        n[len(chunk):] = n[0]

    def _fill_pool(self):
        """One background filler thread: fills batch j+1 while the main
        thread copies and dispatches batch j (the native fill releases the
        GIL). One thread keeps fills in plan order, the order of the ring."""
        if self._fill_ex is None:
            self._fill_ex = ThreadPoolExecutor(1, thread_name_prefix="nisqa-filler")
        return self._fill_ex

    # -- device side ---------------------------------------------------------

    def _consts_for(self, sr: int, kind: str):
        key = (sr, kind)
        if key not in self._consts:
            self._consts[key] = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in front_end_consts(self.ms, sr, kind).items()
            }
        return self._consts[key]

    def _upload(self, slot: _Slot, buf_len: int):
        """Host slot -> device (audio, n int64), then give the slot back.

        On CUDA the copy is non_blocking from pinned memory on the copy
        stream; the compute stream waits on the copy's event, and the device
        tensors are marked as used by the compute stream."""
        host = slot.rows(buf_len)
        if not self._cuda:
            audio, n = host.clone(), slot.n.to(torch.int64)
            slot.release()
            return audio, n
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            audio = host.to(self.device, non_blocking=True)
            n32 = slot.n.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        slot.release(copied)
        cur.wait_event(copied)
        audio.record_stream(cur)
        n32.record_stream(cur)
        return audio, n32.to(torch.int64)

    def _mel(self, gkey, audio, n):
        """Mel stage (the JAX engine's ``_pipeline`` front half): audio ->
        mel dB (B, F, M), kept for the corpus cache."""
        sr, bucket, kind = gkey
        return mel_fn(self.ms, sr, bucket, self._consts_for(sr, kind), audio, n,
                      fast=self.fe_precision == "fast", dft_mel=self.dft_mel)

    def _seg_model(self, gkey, *blocks):
        """Seg+model stage (the JAX engine's ``_seg_pipeline``): the mel
        blocks ``db, n`` of each end (degraded, then reference) ->
        predictions, for any multiple of the batch size in rows."""
        sr, bucket, _ = gkey
        ends = [seg_fn(self.ms, sr, bucket, db, n) for db, n in zip(blocks[::2], blocks[1::2])]
        if self.model.double_ended:
            return self.model.forward_ends(*ends[0], *ends[1])
        return self.model(*ends[0])

    def _sync(self):
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def _run_cold(self, batches, audio, paths, timings, keep, audio_ref=None, paths_ref=None):
        """Fill (filler thread) -> upload -> mel -> seg+model for each
        (gkey, chunk), one fill, upload and mel stage per end. Returns the
        per-batch outputs and, with ``keep``, the (gkey, chunk, db, n) or,
        double-ended, (gkey, chunk, db_d, n_d, db_r, n_r) device blocks for
        the cache. A filler exception reaches the caller through
        ``fut.result()``."""
        timings["fill_s"] = 0.0
        ends = [(audio, paths)] + ([(audio_ref, paths_ref)] if audio_ref is not None else [])

        def fill(slots, chunk, buf_len, kind):
            tf = time.perf_counter()
            for slot, (end_audio, end_paths) in zip(slots, ends):
                self._make_batch(slot, chunk, end_audio, end_paths, buf_len, kind)
            timings["fill_s"] += time.perf_counter() - tf

        jobs = []
        for gkey, chunk in batches:
            buf_len = frame_geometry(self.ms, gkey[0], gkey[1])[4]
            slots = [self._host_buf(gkey[2], e) for e in range(len(ends))]
            jobs.append((slots, buf_len, self._fill_pool().submit(fill, slots, chunk, buf_len, gkey[2])))
        ys, kept = [], []
        wait_s = dispatch_s = 0.0
        try:
            for (gkey, chunk), (slots, buf_len, fut) in zip(batches, jobs):
                tw = time.perf_counter()
                fut.result()
                td = time.perf_counter()
                wait_s += td - tw
                blocks = []
                for slot in slots:
                    audio_d, n_d = self._upload(slot, buf_len)
                    blocks += [self._mel(gkey, audio_d, n_d), n_d]
                ys.append(self._seg_model(gkey, *blocks))
                if keep:
                    kept.append((gkey, chunk, *blocks))
                dispatch_s += time.perf_counter() - td
        except BaseException:
            # free the filler: drop the fills not started, hand every slot
            # back (a running fill may wait on one), and again once it ends
            for _, _, fut in jobs:
                fut.cancel()
            for slots, _, _ in jobs:
                for slot in slots:
                    slot.release()
            wait_futures([fut for _, _, fut in jobs])
            for slots, _, _ in jobs:
                for slot in slots:
                    slot.release()
            raise
        timings["wait_s"] = timings.get("wait_s", 0.0) + wait_s
        timings["dispatch_s"] = timings.get("dispatch_s", 0.0) + dispatch_s
        return ys, kept

    # -- corpus cache ----------------------------------------------------------

    def _fingerprint(self, paths, paths_ref=None):
        """Corpus identity for the device cache: every file's (path, size,
        mtime_ns), degraded ends then references, or None when caching is
        off/unavailable."""
        if self.cache_mb <= 0:
            return None
        try:
            items = []
            for p in list(paths) + list(paths_ref or []):
                st = os.stat(p)
                items.append((p, st.st_size, st.st_mtime_ns))
            return tuple(items)
        except OSError:
            return None

    def _cap_bytes(self):
        return int(self.cache_mb * (1 << 20))

    def _cache_store(self, fp, entry):
        cap = self._cap_bytes()
        if entry["bytes"] > cap:
            return
        while self._cache_bytes + entry["bytes"] > cap and self._corpus_cache:
            oldest = next(iter(self._corpus_cache))
            self._cache_bytes -= self._corpus_cache.pop(oldest)["bytes"]
        self._corpus_cache[fp] = entry
        self._cache_bytes += entry["bytes"]

    def _cache_replace(self, fp, entry):
        old = self._corpus_cache.pop(fp, None)
        if old is not None:
            self._cache_bytes -= old["bytes"]
        self._cache_store(fp, entry)
        return entry

    def _store_cold(self, fp, plan, kept):
        """Keep as many of the cold pass's mel blocks resident as fit the
        cap (plan order, longest files first); the rest is recorded as a
        cold tail that cached passes re-fill every pass."""
        resident, cold, used = _resident_split(kept, lambda t: _nbytes(*t[2:]),
                                               self._cap_bytes())
        if not resident:
            return
        cold_tail = [(gkey, chunk) for gkey, chunk, *_ in cold]
        if cold_tail:
            # sizing advisory on stderr (stdout carries the results)
            need_mb = -(-sum(_nbytes(*t[2:]) for t in kept) // (1 << 20))
            print(
                f"nisqa_tpu_torch: corpus mels exceed the serving cache cap "
                f"({self.cache_mb:.0f} MB): {len(resident)}/{len(kept)} batches stay "
                f"device-resident, {len(cold_tail)} re-decode+re-upload per pass. "
                f"Full residency needs serving_cache_mb >= {need_mb}.",
                file=sys.stderr,
            )
        self._cache_store(fp, {"mode": "mel", "plan": plan, "batches": resident,
                               "cold": cold_tail, "bytes": used})

    def _fuse_cached(self, plan):
        """fuse_pass None/True: cached passes run concatenated parts; a
        single-batch plan has nothing to concatenate."""
        return self.fuse_pass is not False and len(plan) > 1

    def _fuse_plan_chunks(self, plan):
        """Partition a plan into fused parts: maximal runs of consecutive
        same-(sr, bucket, transport) batches, capped so one part's working
        set (segment tensor + a T^2 attention-score estimate) stays under
        _FUSE_CHUNK_BYTES. Returns [[plan indices], ...]."""
        bs = self.batch_size
        chunks, i = [], 0
        while i < len(plan):
            gkey = plan[i][0]
            T = gkey[1]
            per_sample = T * self.ms.n_mels * self.ms.seg_length * 4 + 4 * T * T
            k_cap = max(1, min(16, _FUSE_CHUNK_BYTES // max(1, bs * per_sample)))
            j = i
            while j < len(plan) and plan[j][0] == gkey and j - i < k_cap:
                j += 1
            chunks.append(list(range(i, j)))
            i = j
        return chunks

    def _upgrade_to_fused_parts(self, fp, hit):
        """Each part's resident blocks are concatenated on the device into
        one (k*bs, F, M) block per end (mode 'mel_fused_parts'); a cached
        pass then runs one seg+model call per part at batch k*bs. Per-sample
        compute is independent, so the outputs equal k calls of bs."""
        parts = []
        for idxs in self._fuse_plan_chunks(hit["plan"]):
            batches = [hit["batches"][i] for i in idxs]
            blocks = [torch.cat(xs) if len(xs) > 1 else xs[0]
                      for xs in zip(*(b[2:] for b in batches))]
            parts.append((batches[0][0], *blocks))
        return self._cache_replace(fp, {
            "mode": "mel_fused_parts", "plan": hit["plan"], "parts": parts,
            "bytes": sum(_nbytes(*part[1:]) for part in parts)})

    def _upgrade_to_mel_fused(self, fp, hit):
        """One-time upgrade of a fully resident entry: plans of at most
        FUSE_WHOLE_MAX batches move their mel blocks into one flat device
        tensor (mode 'mel_fused'), one row per end with the same offsets,
        whose parts are views; bigger plans upgrade to concatenated parts."""
        plan = hit["plan"]
        if len(plan) > FUSE_WHOLE_MAX:
            return self._upgrade_to_fused_parts(fp, hit)
        batches = hit["batches"]
        ends = self._ends()
        flat = torch.cat([b[2 + 2 * e].reshape(-1) for e in range(ends) for b in batches])
        flat = flat.view(ends, -1)
        ns = torch.cat([b[3 + 2 * e] for e in range(ends) for b in batches]).view(ends, -1)
        offsets = np.cumsum([0] + [b[2].numel() for b in batches])
        bs, M = self.batch_size, self.ms.n_mels
        parts = []
        for idxs in self._fuse_plan_chunks(plan):
            i, j = idxs[0], idxs[-1] + 1
            gkey = plan[i][0]
            blocks = []
            for e in range(ends):
                blocks += [flat[e, int(offsets[i]) : int(offsets[j])].view(
                    (j - i) * bs, self.ms.frames_for_bucket(gkey[1]), M), ns[e, i * bs : j * bs]]
            parts.append((gkey, *blocks))
        return self._cache_replace(fp, {
            "mode": "mel_fused", "plan": plan, "flat": flat, "ns": ns, "parts": parts,
            "bytes": _nbytes(flat, ns)})

    def _run_fused_parts(self, hit):
        """One seg+model call per part, outputs in plan order."""
        return [self._seg_model(*part) for part in hit["parts"]]

    def _partial_cached_pass(self, hit, paths, paths_ref, N, fetch, timings):
        """Cache hit for a corpus that only partly fits ``cache_mb``: the
        resident batches run seg+model over their cached mel blocks first
        (the device works on them while the host scans the tail); then only
        the cold tail's files (both ends of its pairs) are re-scanned,
        re-filled and re-uploaded."""
        cold = hit["cold"]
        timings["resident_batches"] = len(hit["batches"])
        timings["cold_batches"] = len(cold)
        td = time.perf_counter()
        ys = [self._seg_model(gkey, *blocks) for gkey, _, *blocks in hit["batches"]]
        timings["dispatch_s"] = time.perf_counter() - td

        ts = time.perf_counter()
        tail_idx = sorted({i for _, chunk in cold for i in chunk})

        def tail(end_paths):
            out = [None] * N
            for i, e in zip(tail_idx, self._scan_transport([end_paths[i] for i in tail_idx])):
                out[i] = e
            return out

        audio = tail(paths)
        audio_ref = tail(paths_ref) if paths_ref is not None else None
        timings["scan_plan_s"] = time.perf_counter() - ts

        ys += self._run_cold(cold, audio, paths, timings, False, audio_ref, paths_ref)[0]
        chunks = [chunk for _, chunk, *_ in hit["batches"]] + [chunk for _, chunk in cold]
        return self._collect(ys, chunks, N, fetch, timings)

    # -- passes ------------------------------------------------------------------

    def predict_paths(self, paths, paths_ref=None, fetch=True):
        """Predict for audio paths -> (N, out_dim) float32, in input order.

        A double-ended model takes ``paths_ref``, the reference file of each
        degraded file in ``paths``; a single-ended one takes none. Runs one
        of the regimes of the module docstring; all give the same
        predictions. ``fetch=False`` synchronises and returns None.
        ``fetch="async"`` returns a zero-argument handle that yields the
        result: on a fully cached pass the readback is deferred into the
        handle (it waits on the copy's CUDA event), so the caller can
        dispatch the next pass first; cold and partial passes resolve
        eagerly (their staging slots are reused by the next pass) and the
        handle hands the result back. Under a mesh every rank makes the
        same passes in the same order; each pass's all-reduce runs at
        dispatch, so the handles resolve in any order.
        """
        if fetch not in (True, False, "async"):
            raise ValueError(f"fetch must be True, False or 'async', got {fetch!r}")
        paths = list(paths)
        paths_ref = self._check_ref(paths, paths_ref)
        N = len(paths)
        if N == 0:
            empty = np.zeros((0, 5 if self.model.dim else 1), np.float32)
            if fetch == "async":
                return lambda: empty
            return empty if fetch else None
        t0 = time.perf_counter()
        fp = self._fingerprint(paths, paths_ref)
        hit = self._corpus_cache.pop(fp, None) if fp is not None else None
        with self._serving():
            if hit is not None:
                self._corpus_cache[fp] = hit  # LRU refresh
                return self._cached_pass(fp, hit, paths, paths_ref, N, fetch, t0)
            return self._cold_pass(fp, paths, paths_ref, N, fetch, t0)

    @contextlib.contextmanager
    def _serving(self):
        """A pass's context: eval mode (a model in training, e.g. between
        the epochs of the train loop, gets its mode back after the pass),
        no autograd and the engine's precision. The corpus mel cache stays
        valid across weight updates: mels do not depend on the weights."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode(), matmul_precision(self.precision):
                yield
        finally:
            self.model.train(was_training)

    def _cold_pass(self, fp, paths, paths_ref, N, fetch, t0):
        audio, audio_ref, plan = self._scan_plan(paths, paths_ref)
        t_plan = time.perf_counter()
        timings = {}
        ys, kept = self._run_cold(plan, audio, paths, timings, fp is not None, audio_ref, paths_ref)
        if fp is not None:
            self._store_cold(fp, plan, kept)
        del kept
        out = self._collect(ys, [chunk for _, chunk in plan], N,
                            True if fetch == "async" else fetch, timings)
        self._note_pass("interleaved", N, len(plan), t0, t_plan, time.perf_counter(), timings)
        return (lambda: out) if fetch == "async" else out

    def _cached_pass(self, fp, hit, paths, paths_ref, N, fetch, t0):
        timings = {}
        if hit.get("cold"):
            out = self._partial_cached_pass(hit, paths, paths_ref, N,
                                            True if fetch == "async" else fetch, timings)
            self._note_pass("cached_partial", N, len(hit["plan"]), t0, t0,
                            time.perf_counter(), timings)
            return (lambda: out) if fetch == "async" else out
        td = time.perf_counter()
        if hit["mode"] == "mel" and self._fuse_cached(hit["plan"]):
            hit = self._upgrade_to_mel_fused(fp, hit)
        if hit["mode"] == "mel":
            ys = [self._seg_model(gkey, *blocks) for gkey, _, *blocks in hit["batches"]]
        else:
            ys = self._run_fused_parts(hit)
        timings["dispatch_s"] = time.perf_counter() - td
        out = self._collect(ys, [chunk for _, chunk in hit["plan"]], N, fetch, timings)
        self._note_pass("cached", N, len(hit["plan"]), t0, t0, time.perf_counter(), timings)
        return out

    def _scatter(self, all_y, chunks, N):
        """Rows j*bs .. j*bs+len(chunk) of the pass's outputs belong to the
        j-th batch's files. Under a mesh the all-reduce put them there."""
        if self.mesh is not None:
            return all_y
        bs = self.batch_size
        out = np.zeros((N, all_y.shape[1]), dtype=np.float32)
        for j, chunk in enumerate(chunks):
            out[np.asarray(chunk)] = all_y[j * bs : j * bs + len(chunk)]
        return out

    def _readback(self, all_dev):
        """Start the pass's one device->host copy into pinned memory;
        returns (host tensor, CUDA event of the copy or None)."""
        if not self._cuda:
            return all_dev, None
        host = torch.empty(all_dev.shape, dtype=all_dev.dtype, pin_memory=True)
        host.copy_(all_dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _sum_ranks(self, ys, chunks, N):
        """(N, K) on the device of every rank: the rows of this rank's
        batches at their files, zeros elsewhere, summed over the ranks."""
        bs = self.batch_size
        pos = [j * bs + r for j, chunk in enumerate(chunks) for r in range(len(chunk))]
        rows = torch.tensor([i for chunk in chunks for i in chunk], dtype=torch.int64)
        if ys:
            values = torch.cat(ys)[torch.tensor(pos, dtype=torch.int64).to(self.device)]
        else:  # more ranks than batches: this rank computed nothing
            values = torch.zeros((0, 5 if self.model.dim else 1), device=self.device)
        return sum_rows(rows.to(self.device), values, N, self.mesh.group)

    def _collect(self, ys, chunks, N, fetch, timings):
        """The pass's (N, K) result from its batches' outputs ``ys``: one
        device->host readback, then the rows are put at their files. Under
        a mesh the rows are put on the device instead, by the pass's one
        all-reduce (:meth:`_sum_ranks`), made here at dispatch whatever the
        regime or ``fetch``, so every rank makes it at the same point."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            all_dev = self._sum_ranks(ys, chunks, N)
        else:
            all_dev = torch.cat(ys) if len(ys) > 1 else ys[0]
        if fetch == "async":
            host, done = self._readback(all_dev)

            def resolve():
                if done is not None:
                    done.synchronize()
                return self._scatter(host.numpy(), chunks, N)

            return resolve
        self._sync()
        t1 = time.perf_counter()
        timings["block_s"] = t1 - t0
        if not fetch:
            return None
        host, done = self._readback(all_dev)
        if done is not None:
            done.synchronize()
        timings["fetch_s"] = time.perf_counter() - t1
        return self._scatter(host.numpy(), chunks, N)

    def _note_pass(self, mode, n_files, n_batches, t0, t_plan, t_end, timings=None):
        """Cumulative and last-pass statistics. ``timings`` (host clocks)
        adds scan_plan_s (header scan + plan), fill_s (filler-thread decode),
        wait_s (main thread blocked on fills), dispatch_s (uploads and
        kernel launches), block_s (wait for the device), fetch_s (readback),
        and resident_batches / cold_batches on partial passes."""
        s = self.stats
        s["passes"] += 1
        s["files"] += n_files
        s["cache_hits"] += 1 if mode in ("cached", "cached_partial") else 0
        s["last"] = {
            "mode": mode,
            "files": n_files,
            "batches": n_batches,
            "wall_s": round(t_end - t0, 4),
            "scan_plan_s": round(t_plan - t0, 4),
            **{k: round(v, 4) for k, v in (timings or {}).items()},
        }

    # -- warmup ------------------------------------------------------------------

    def warmup(self, paths, paths_ref=None):
        """Run each (sr, bucket, transport) shape ``paths`` (and, for a
        double-ended model, ``paths_ref``) need once, on zero batches:
        builds the kernel library, prepares the constants, grows the pinned
        staging rings to the corpus's largest batch, and, for the regime the
        cache will take, runs the seg+model shapes of the cached passes (the
        fused parts' k*bs rows included). Returns the shapes run as (stage,
        gkey, rows)."""
        paths = list(paths)
        paths_ref = self._check_ref(paths, paths_ref)
        if not paths:
            return []
        ms, bs, M = self.ms, self.batch_size, self.ms.n_mels
        ends = self._ends()
        plan = self._scan_plan(paths, paths_ref)[2]
        gkeys = sorted({gkey for gkey, _ in plan})

        def full_n(sr, bucket):
            hop = int(sr * ms.hop_s)
            return ((bucket - 1) * ms.seg_hop + ms.seg_length - 1) * hop

        def block_bytes(bucket):  # mel blocks float32 + n int64 per end, as the cache holds them
            return ends * (bs * ms.frames_for_bucket(bucket) * M * 4 + bs * 8)

        cap = self._cap_bytes()
        resident, _, _ = _resident_split(plan, lambda e: block_bytes(e[0][1]), cap)
        resident_keys = {gkey for gkey, _ in resident}
        if self.cache_mb <= 0 or not resident_keys:
            seg_shapes = []
        elif sum(block_bytes(b) for (_, b, _), _ in plan) > cap:
            seg_shapes = [(gkey, bs) for gkey in sorted(resident_keys)]  # partial regime
        elif self._fuse_cached(plan):
            seg_shapes = sorted({(plan[idxs[0]][0], len(idxs) * bs)
                                 for idxs in self._fuse_plan_chunks(plan)})
        else:
            seg_shapes = [(gkey, bs) for gkey in gkeys]

        warmed = []
        with self._serving():
            lens = {gkey: frame_geometry(ms, gkey[0], gkey[1])[4] for gkey in gkeys}
            for kind in {gkey[2] for gkey in gkeys}:
                longest = max(lens[g] for g in gkeys if g[2] == kind)
                for end in range(ends):
                    ring = [self._host_buf(kind, end) for _ in range(RING_SLOTS)]
                    for slot in ring:
                        slot.acquire(longest)
                    for slot in ring:
                        slot.release()
            for gkey in gkeys:
                blocks = []
                for end in range(ends):
                    slot = self._host_buf(gkey[2], end)
                    buf, n = slot.acquire(lens[gkey])
                    buf.fill(0)
                    n.fill(full_n(gkey[0], gkey[1]))
                    audio_d, n_d = self._upload(slot, lens[gkey])
                    blocks += [self._mel(gkey, audio_d, n_d), n_d]
                self._seg_model(gkey, *blocks)
                warmed.append(("cold", gkey, bs))
            for gkey, rows in seg_shapes:
                db = torch.zeros((rows, ms.frames_for_bucket(gkey[1]), M), device=self.device)
                n = torch.full((rows,), full_n(gkey[0], gkey[1]), dtype=torch.int64,
                               device=self.device)
                self._seg_model(gkey, *(db, n) * ends)
                warmed.append(("seg", gkey, rows))
            self._sync()
        return warmed
