"""The host fill below both engines (:class:`HostFill`): the header scan,
pinned staging rings, the decode + reflect-pad of a batch into a slot, its
upload, and the front-end's constants on the device. The serving engine
(``pipeline.InferenceEngine``) and the train engine (``train.loop``) each
own one; this module imports neither.

A scanned file is a transport entry: ('native', n, sr) / ('native_f32', n,
sr) from the C++ header scan (decoded later, by the fill), a tuple decoded
in Python, ('i16', raw PCM16, sr) / ('f32', samples, sr), or the train
engine's ('meta', n, sr) stub of a device-resident row.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..audio import wav as wavio
from ..audio.melspec import pad_audio_for_batch
from . import native
from .front_end import front_end_consts


def n_samples(entry) -> int:
    """Sample count of a transport entry: header-scanned and 'meta' entries
    carry n, decoded ones the samples."""
    return entry[1] if entry[0] in ("native", "native_f32", "meta") else len(entry[1])


def transport_kind(entry) -> str:
    """The transport a scanned entry fills by: 'i16' or 'f32'."""
    return {"native": "i16", "native_f32": "f32"}.get(entry[0], entry[0])


def n_wins_of(ms, i, entries, entries_ref=None) -> int:
    """n_wins of file ``i`` at its sample rate; a pair (``entries_ref``
    given) takes the larger of its two ends."""
    sr = entries[i][2]
    return max(ms.n_wins(ms.n_frames(n_samples(e[i]), sr))
               for e in (entries, entries_ref) if e is not None)


def bucket_of(ms, idx, entries, entries_ref=None) -> int:
    """The T bucket of the longest file of ``idx`` (a pair's longer end);
    an over-long file raises the reference's ms_max_segments error."""
    return ms.bucket_for(max(n_wins_of(ms, i, entries, entries_ref) for i in idx))


def validate_filled_row(ms, path, n, sr, sr_got=None):
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


class _Slot:
    """One host staging buffer of a ring: pinned on a CUDA device.

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


class HostFill:
    """Scan, staging rings, batch fill, upload and front-end constants for
    one device. ``num_workers``: threads of the header scan, the Python
    decode fallback and (unless a call says otherwise) the native fill.
    ``slots``: the depth of each ring, how many batches of one transport
    and end the fill may run ahead of their copies."""

    def __init__(self, ms, device, num_workers: int, slots: int):
        self.ms = ms
        self.device = torch.device(device)
        self.num_workers = max(1, int(num_workers))
        self.slots = int(slots)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._consts = {}
        self.rings = {}  # (kind, end, bs) -> [_Slot] * slots
        self._next = {}

    def load_audio(self, path):
        y, sr = wavio.read_wav(path, channel=self.ms.channel)
        if self.ms.sr:
            y = wavio.resample_kaiser(y, sr, int(self.ms.sr))
            sr = int(self.ms.sr)
        return y, sr

    def load_audio_transport(self, path):
        """('i16', raw PCM16, sr) for plain 16-bit mono PCM without
        resampling, else ('f32', float samples, sr)."""
        ms = self.ms
        if not ms.sr:
            raw = wavio.read_wav_pcm16_mono(path)
            if raw is not None and len(raw[0]) >= ms.n_fft // 2 + 2:
                return ("i16", raw[0], raw[1])
        y, sr = self.load_audio(path)
        return ("f32", y, sr)

    def scan(self, paths):
        """Per-file transport entries: ('native', n, sr) / ('native_f32',
        n, sr) from the C++ header scan, or a decoded tuple from
        :meth:`load_audio_transport`."""
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
                for i, v in zip(todo, ex.map(self.load_audio_transport, (paths[i] for i in todo))):
                    out[i] = v
        return out

    def slot(self, kind: str, end: int, bs: int) -> _Slot:
        """The next slot of the ring of ``kind``, ``end`` (0 the degraded
        end, 1 the reference) and ``bs`` rows, taken in the order the
        batches are filled."""
        key = (kind, end, bs)
        ring = self.rings.get(key)
        if ring is None:
            dtype = torch.int16 if kind == "i16" else torch.float32
            ring = self.rings[key] = [_Slot(dtype, bs, self._cuda) for _ in range(self.slots)]
            self._next[key] = 0
        j = self._next[key]
        self._next[key] = (j + 1) % self.slots
        return ring[j]

    def drop(self, bs: int):
        """Free the rings of ``bs``-row batches (one made again starts anew)."""
        self.rings = {k: v for k, v in self.rings.items() if k[2] != bs}

    def batch(self, slot: _Slot, chunk, audio, paths, buf_len, kind, n_threads=None):
        """Decode + reflect-pad the files ``chunk`` of ``audio`` into
        ``slot`` with ``n_threads`` decode threads (None: ``num_workers``).
        Rows past the chunk take row 0's length (finite, dropped after the
        forward). Returns the host seconds spent waiting for the slot and
        decoding (the native fill call, and the rows written in Python)."""
        pad, ms = self.ms.n_fft // 2, self.ms
        n_threads = n_threads or self.num_workers
        t = time.perf_counter()
        buf, n = slot.acquire(buf_len)
        slot_s, decode_s = time.perf_counter() - t, 0.0
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
            t = time.perf_counter()
            if kind == "i16":
                ns, srs, status = native.fill_batch_i16(src, target, pad, n_threads=n_threads)
            else:
                ns, srs, status = native.fill_batch_f32(
                    src, target, pad, channel=ms.channel, n_threads=n_threads)
            decode_s += time.perf_counter() - t
            for row, (j, i) in enumerate(native_items):
                if status[row] == 0:
                    validate_filled_row(ms, paths[i], ns[row], audio[i][2], srs[row])
                    if not all_native:
                        buf[j] = target[row]
                    n[j] = ns[row]
                    continue
                # rare race (file changed since scan): decode in Python below
                t = time.perf_counter()
                x, sr_got = self.load_audio(paths[i])
                decode_s += time.perf_counter() - t
                validate_filled_row(ms, paths[i], len(x), audio[i][2], sr_got)
                if kind == "i16":
                    x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
                audio[i] = (kind, x, audio[i][2])
        t = time.perf_counter()
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
        return slot_s, decode_s + time.perf_counter() - t

    def upload(self, slot: _Slot, buf_len: int):
        """Host slot -> device (audio, n int64), then give the slot back.

        On CUDA the copy is non_blocking from pinned memory on the copy
        stream; the current stream waits on the copy's event, and the device
        tensors are marked as used by it."""
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

    def consts(self, sr: int, kind: str):
        """The front-end's constants of (``sr``, transport) on the device."""
        key = (sr, kind)
        if key not in self._consts:
            self._consts[key] = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in front_end_consts(self.ms, sr, kind).items()
            }
        return self._consts[key]
