"""Training loops (MOS and multidimensional) on one device.

Counterpart of ``nisqa_tpu/train/loop.py``: Adam, reduce-on-plateau
(relative threshold 0.003), early stopping and the optional bias loss; the
train-mode predictions of each epoch feed the train-set metrics, a
validation pass through the serving engine follows every epoch, and each
epoch writes a row of the results CSV and its checkpoints.

A train step (:meth:`TrainEngine._run_group`), per batch and sample rate,
takes its segments from one of two fills:

  host fill (:meth:`TrainEngine._batch`): decode + reflect-pad the batch
          into a pinned staging slot (the i16 transport when every file is
          plain PCM16 mono and the model is single-ended, float32
          otherwise), upload non_blocking, with the serving engine's fill
          and copy; then ``mel_fn`` (the DFT->mel kernel in exact mode) and
          ``seg_fn`` under ``torch.no_grad()`` -- audio is data, no
          gradient reaches the front-end;
  device corpus (``tr_ds_to_memory``, :meth:`TrainEngine._gather`): the
          corpus's mel-dB rows, built once per sample rate (and end) through
          the same front-end in 64-row chunks and kept on the device within
          ``tr_device_cache_mb``; a step gathers its rows with
          ``index_select`` and runs ``seg_fn``: no decode, no upload of
          audio, no front-end. Rows over the budget (the shortest files of a
          group) stay on the host fill.

Then both run the train-mode forward (masked batch norm, dropout), the loss,
backward and ``torch.optim.Adam``.

Losses and predictions stay on the device until the epoch ends: a readback
per step would make the host wait for the device. Deliberate differences
from the JAX package: the shuffle order and the dropout masks come from
numpy and torch generators seeded from ``(seed, epoch)``, which cannot
reproduce JAX's PRNG; the full train state for ``tr_resume`` is a ``.pt``
file, not flax's ``.msgpack``; the epoch loss weighs the two sub-steps of a
group split by partial residency by their rows (one term of the mean, where
``nisqa_tpu`` counts two); and there is no data parallelism
(``tr_parallel``): it trains on one device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..data.dataset import Table
from ..data.front_end import frame_geometry, mel_fn, seg_fn
from ..data.pipeline import _Slot, matmul_precision
from ..eval.report import eval_results
from ..ops.dft_mel import fused_dft_mel
from .bias_loss import BiasLoss
from .checkpoint import load_train_state, save_train_state
from .early_stop import EarlyStopper, EarlyStopperDim
from .plateau import ReduceLROnPlateau

# pinned staging slots per (transport, end): a slot is refilled only after
# the copy that read it is done, so two let the fill of step j+1 start while
# step j's copy may still be in flight
SLOTS = 2
# rows per chunk of the device corpus's build, and the granularity of a
# group's resident head
CHUNK = 64


def _n_of(e):
    """Sample count of a transport entry: header-scanned ('native',
    'native_f32') and released ('meta') entries carry n, decoded ones the
    samples."""
    return e[1] if e[0] in ("native", "native_f32", "meta") else len(e[1])


def nan_mse(pred, target):
    """Mean squared error over the non-NaN targets."""
    ok = ~torch.isnan(target)
    err = torch.where(ok, pred - target, 0.0)
    return (err * err).sum() / ok.sum().clamp(min=1)


def train_loss(y_hat, y, bias_b, loss_weight: float = 0.0):
    """Sum over the K targets of the NaN-masked MSE of the bias-mapped
    prediction ``b0 + b1 y + b2 y^2 + b3 y^3`` (``bias_b`` (B, K, 4)), plus
    ``loss_weight`` times the MSE of the raw prediction."""
    mapped = (bias_b[..., 0] + bias_b[..., 1] * y_hat + bias_b[..., 2] * y_hat ** 2
              + bias_b[..., 3] * y_hat ** 3)
    return sum(nan_mse(mapped[:, k], y[:, k]) + loss_weight * nan_mse(y_hat[:, k], y[:, k])
               for k in range(y.shape[1]))


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's shuffle and dropout masks: a function of (seed,
    epoch) alone, so a resumed run draws what an uninterrupted one does."""
    return int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])


class TrainEngine:
    """Train steps for the runner's model on its device, from the host fill
    or from the device-resident corpus. ``dft_mel`` is the front-end's
    DFT->mel step (the CUDA kernel for device tensors, its twin for CPU
    tensors)."""

    def __init__(self, runner, loss_weight: float = 0.0):
        args = runner.args
        self.runner = runner
        self.model = runner.model
        self.ms = runner.ms
        self.device = runner.device
        self.loss_weight = float(loss_weight)
        self.dft_mel = fused_dft_mel
        # the reference trains in full float32; tr_precision='default' allows TF32
        self.precision = args.get("tr_precision") or "highest"
        self.seed = int(args.get("seed") or 0)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=float(args["tr_lr"]))
        self.generator = torch.Generator(device=self.device)
        self.model.set_dropout_generator(self.generator)
        self._rings = {}
        self.steps = 0  # train steps run (one per batch and sample rate, two for a split group)
        # per epoch: steps, files, wall_s, the loss terms (and build_s, val_s)
        self.history = []
        # the device-resident corpus: per sample rate, mel-dB rows of the
        # files that fit tr_device_cache_mb (None means 1,024 MB; an explicit
        # 0 turns residency off, which an `or` default would not)
        self.to_memory = bool(args.get("tr_ds_to_memory"))
        cap = args.get("tr_device_cache_mb")
        self.cache_mb = 1024.0 if cap is None else float(cap)
        # decode threads of the corpus build: 0 or None means tr_num_workers, else 4
        self.preload_threads = max(1, int(args.get("tr_ds_to_memory_workers")
                                          or args.get("tr_num_workers") or 4))
        self._scans = {}  # under tr_ds_to_memory: paths -> transport entries, kept across epochs
        self._corpus, self._corpus_key = None, None
        self.build_s = None  # wall time of the corpus build in the current epoch, if any
        if args.get("tr_parallel"):
            print("nisqa_tpu_torch: tr_parallel: data parallelism is not ported; "
                  "training runs on one device", file=sys.stderr)

    # -- host side -------------------------------------------------------------

    def _entries(self, paths):
        """Transport descriptors through the serving engine's header scan.
        Under ``tr_ds_to_memory`` the list is scanned once and kept: its
        decoded fallback tuples are the host audio of the rows that do not
        go resident, and resident rows become ('meta', n, sr) stubs."""
        key = tuple(paths)
        hit = self._scans.get(key)
        if hit is None:
            hit = self.runner._engine()._scan_transport(list(paths))
            if self.to_memory:
                self._scans[key] = hit
        return hit

    def _slot(self, kind: str, end: int, bs: int) -> _Slot:
        key = (kind, end, bs)
        ring = self._rings.get(key)
        if ring is None:
            dtype = torch.int16 if kind == "i16" else torch.float32
            ring = self._rings[key] = [[_Slot(dtype, bs, self.device.type == "cuda")
                                        for _ in range(SLOTS)], 0]
        slots, j = ring
        ring[1] = (j + 1) % SLOTS
        return slots[j]

    def _to_device(self, a: np.ndarray):
        """A host array on the device; on CUDA through pinned memory and
        non_blocking, so that a step never waits for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- device-resident corpus --------------------------------------------------

    def _device_corpus(self, paths, entries, paths_ref, entries_ref):
        """The corpus of ``(paths, paths_ref)``, built at its first epoch
        (which sets ``build_s``, synchronised); {} without ``tr_ds_to_memory``."""
        if not self.to_memory:
            return {}
        key = (tuple(paths), tuple(paths_ref) if paths_ref is not None else None)
        if key != self._corpus_key:
            self._corpus = self._corpus_key = None  # free the old rows first
            t0 = time.perf_counter()
            self._corpus = self._build_device_corpus(paths, entries, paths_ref, entries_ref)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.build_s = time.perf_counter() - t0
            self._corpus_key = key
        return self._corpus

    def _build_device_corpus(self, paths, entries, paths_ref, entries_ref):
        """{sr: {sr, mel, n, bucket, kind, local[, mel_ref, n_ref]}}: per
        sample rate, the mel-dB rows (n_rows, F, n_mels) float32 of the files
        that fit ``tr_device_cache_mb``, at the bucket of the group's longest
        file (a pair's longer end), with their sample counts and ``local``
        (file index -> row).

        The budget counts the rows padded to a multiple of ``CHUNK``. A group
        over what is left keeps its longest files, in ``CHUNK``-row
        granularity (longest first: they pack the most audio per resident
        byte, and the tail left to the host fill uploads the fewest bytes);
        when not even ``CHUNK`` rows fit, the group stays on the host fill.
        Both cases print an advisory. A resident row's entries become
        ('meta', n, sr): its host audio is released."""
        ms = self.ms
        by_sr = {}
        for i, e in enumerate(entries):
            by_sr.setdefault(e[2], []).append(i)
        budget = int(self.cache_mb * (1 << 20))
        out = {}
        for sr, gidx in sorted(by_sr.items()):
            nw = [ms.n_wins(ms.n_frames(_n_of(entries[i]), sr)) for i in gidx]
            if entries_ref is not None:
                nw = [max(a, ms.n_wins(ms.n_frames(_n_of(entries_ref[i]), sr)))
                      for a, i in zip(nw, gidx)]
            # raises the reference's ms_max_segments error for an over-long file
            bucket = ms.bucket_for(max(nw))
            n_rows = -(-len(gidx) // CHUNK) * CHUNK
            row_bytes = (ms.frames_for_bucket(bucket) * ms.n_mels * 4
                         * (2 if entries_ref is not None else 1))
            if n_rows * row_bytes > budget:
                n_keep = budget // row_bytes // CHUNK * CHUNK
                need_mb = -(-(n_rows * row_bytes) // (1 << 20))
                if n_keep <= 0:
                    print(f"nisqa_tpu_torch: training corpus mels (sr {sr}) exceed "
                          f"tr_device_cache_mb ({self.cache_mb:.0f} MB) and not even a "
                          f"{CHUNK}-row head fits: 0/{len(gidx)} rows device-resident, every "
                          f"epoch re-decodes and re-uploads. Full residency needs "
                          f"tr_device_cache_mb >= {need_mb}.", file=sys.stderr)
                    continue
                order = sorted(range(len(gidx)), key=lambda j: (-nw[j], j))
                print(f"nisqa_tpu_torch: training corpus mels (sr {sr}) exceed "
                      f"tr_device_cache_mb ({self.cache_mb:.0f} MB): {n_keep}/{len(gidx)} rows "
                      f"(longest files) stay device-resident, the tail host-fills per epoch. "
                      f"Full residency needs tr_device_cache_mb >= {need_mb}.", file=sys.stderr)
                gidx = [gidx[o] for o in order[:n_keep]]
                n_rows = n_keep
            mel, n, all_i16 = self._mel_corpus(entries, paths, gidx, sr, bucket, n_rows,
                                               want_i16=entries_ref is None, end=0)
            # the kind is kept for reports and tests: i16 and f32 give the same mel
            entry = {"sr": sr, "mel": mel, "n": n, "bucket": bucket,
                     "kind": "i16" if all_i16 else "f32",
                     "local": {i: j for j, i in enumerate(gidx)}}
            if entries_ref is not None:
                entry["mel_ref"], entry["n_ref"], _ = self._mel_corpus(
                    entries_ref, paths_ref, gidx, sr, bucket, n_rows, want_i16=False, end=1)
            out[sr] = entry
            budget -= n_rows * row_bytes
            for i in gidx:
                entries[i] = ("meta", _n_of(entries[i]), sr)
                if entries_ref is not None:
                    entries_ref[i] = ("meta", _n_of(entries_ref[i]), sr)
        # the build's staging slots are not needed again
        self._rings = {k: v for k, v in self._rings.items() if k[2] != CHUNK}
        return out

    def _mel_corpus(self, entries, paths, gidx, sr, bucket, n_rows, want_i16, end):
        """Streams one group of one end through the front-end in ``CHUNK``-row
        chunks: the serving engine's ``_make_batch`` fills a ``CHUNK``-row
        pinned slot (i16 when ``want_i16`` and every file of the chunk is
        plain PCM16 mono, else f32), ``_upload`` copies it, and ``mel_fn``
        (exact mode, "highest") writes the chunk's rows into the corpus.
        Only the mel rows are kept; each chunk's audio is dropped before the
        next. The pad rows past the group are never gathered. Built under
        ``torch.no_grad()``, not ``inference_mode``: autograd cannot save
        inference tensors for the backward of the steps that read them.

        Returns (mel (n_rows, F, n_mels) float32, n (n_rows,) int64 sample
        counts, whether every chunk took i16)."""
        ms = self.ms
        eng = self.runner._engine()
        buf_len = frame_geometry(ms, sr, bucket)[4]
        mel = torch.empty((n_rows, ms.frames_for_bucket(bucket), ms.n_mels), device=self.device)
        n = torch.zeros((n_rows,), dtype=torch.int64, device=self.device)
        all_i16 = want_i16
        with torch.no_grad(), matmul_precision("highest"):
            for s in range(0, n_rows, CHUNK):
                rows = gidx[s : s + CHUNK]
                kind = "i16" if want_i16 and all(entries[i][0] == "native" for i in rows) else "f32"
                all_i16 = all_i16 and kind == "i16"
                slot = self._slot(kind, end, CHUNK)
                eng._make_batch(slot, rows, entries, paths, buf_len, kind,
                                n_threads=self.preload_threads)
                audio, cn = eng._upload(slot, buf_len)
                mel[s : s + CHUNK] = mel_fn(ms, sr, bucket, eng._consts_for(sr, kind), audio, cn,
                                            fast=False, dft_mel=self.dft_mel)
                n[s : s + len(rows)] = cn[: len(rows)]
                del audio, cn
        return mel, n, all_i16

    # -- one step ----------------------------------------------------------------

    def _batch(self, idx, paths, paths_ref, entries, entries_ref, bs, kind):
        """Fill, upload and front-end one group of files (one sample rate):
        returns [(segs, n_wins)] per end on the device. The serving engine's
        ``_make_batch`` fills the slot (native decode, a file it misses
        decoded in Python) and its ``_upload`` copies it; the rows past the
        group are dropped."""
        ms = self.ms
        eng = self.runner._engine()
        sr = entries[idx[0]][2]
        ends = [(paths, entries)] + ([(paths_ref, entries_ref)] if paths_ref is not None else [])
        for end_paths, end_entries in ends:
            for i in idx:
                if end_entries[i][0] == "meta":
                    raise RuntimeError(
                        f"host audio for device-resident row {end_paths[i]} was released -- "
                        "this row should be served from the mel corpus")
        bucket = ms.bucket_for(max(ms.n_wins(ms.n_frames(_n_of(e[i]), sr))
                                   for _, e in ends for i in idx))
        buf_len = frame_geometry(ms, sr, bucket)[4]
        blocks = []
        for end, (end_paths, end_entries) in enumerate(ends):
            slot = self._slot(kind, end, bs)
            eng._make_batch(slot, idx, end_entries, end_paths, buf_len, kind)
            audio, n = eng._upload(slot, buf_len)
            blocks.append((audio[: len(idx)], n[: len(idx)]))
        consts = eng._consts_for(sr, kind)
        # the front-end is pinned to float32 whatever tr_precision says
        with torch.no_grad(), matmul_precision("highest"):
            return [seg_fn(ms, sr, bucket, mel_fn(ms, sr, bucket, consts, audio, n, fast=False,
                                                  dft_mel=self.dft_mel), n)
                    for audio, n in blocks]

    def _gather(self, idx, c):
        """[(segs, n_wins)] per end of the resident rows of files ``idx`` in
        the corpus group ``c``: an on-device ``index_select`` of the mel rows
        and ``seg_fn`` at the group's bucket. No kernel launch."""
        ids = self._to_device(np.array([c["local"][i] for i in idx], dtype=np.int64))
        ends = [("mel", "n")] + ([("mel_ref", "n_ref")] if "mel_ref" in c else [])
        with torch.no_grad():
            return [seg_fn(self.ms, c["sr"], c["bucket"], c[m].index_select(0, ids),
                           c[k].index_select(0, ids)) for m, k in ends]

    def _loss(self, segs, y, bias_b):
        """Train-mode forward and loss: (loss, predictions (B, K))."""
        if self.model.double_ended:
            y_hat = self.model.forward_ends(*segs[0], *segs[1])
        else:
            y_hat = self.model(*segs[0])
        return train_loss(y_hat, y, bias_b, self.loss_weight), y_hat

    def _targets(self, idx, y_all, bias_losses):
        """Targets (B, K) and bias coefficients (B, K, 4) of files ``idx`` on the device."""
        bias_b = np.stack([bl.coeffs(idx) for bl in bias_losses], axis=1)
        return self._to_device(y_all[idx]), self._to_device(bias_b)

    def _run_group(self, segs, idx, y_all, bias_losses):
        """One train step on the segments of files ``idx``, from either fill:
        forward, loss, backward, Adam. Returns (loss, predictions) on the device."""
        y, bias_b = self._targets(idx, y_all, bias_losses)
        with matmul_precision(self.precision):
            loss, y_hat = self._loss(segs, y, bias_b)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
        self.steps += 1
        return loss.detach(), y_hat.detach()

    # -- one epoch -----------------------------------------------------------------

    def run_epoch(self, ds, bias_losses, lr, epoch, batch_size, shuffle=True, verbose=0):
        """One pass over ``ds`` in batches of ``batch_size`` (a batch of
        mixed sample rates takes one step per rate). Returns (the epoch
        loss, train-mode predictions (N, K) in dataset order).

        Under partial residency the shuffled order is stable-partitioned,
        resident files first, so that at most one (batch, rate) group holds
        both; that group takes a gather and a fill sub-step. The epoch loss
        is the mean over the (batch, rate) groups of their loss, a split
        group's two sub-steps weighted by their rows."""
        t0 = time.perf_counter()
        paths, paths_ref = ds.paths(), ds.paths_ref()
        y_all = ds.targets()
        n_files, n_targets = y_all.shape
        seed = epoch_seed(self.seed, epoch)
        order = np.arange(n_files)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        self.generator.manual_seed(seed)
        entries = self._entries(paths)
        entries_ref = self._entries(paths_ref) if paths_ref is not None else None
        self.build_s = None
        corpus = self._device_corpus(paths, entries, paths_ref, entries_ref)
        if corpus:
            resident = np.zeros(n_files, dtype=bool)
            for c in corpus.values():
                resident[list(c["local"])] = True
            order = np.concatenate([order[resident[order]], order[~resident[order]]])
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.model.train()

        terms = []  # per (batch, sample rate): [(file indices, loss, predictions)] of its steps
        n_batches = -(-n_files // batch_size)
        for b, start in enumerate(range(0, n_files, batch_size)):
            by_sr = {}
            for i in order[start : start + batch_size]:
                by_sr.setdefault(entries[i][2], []).append(int(i))
            for sr, g in by_sr.items():
                c = corpus.get(sr)
                local = c["local"] if c is not None else {}
                gathered = [i for i in g if i in local]
                filled = [i for i in g if i not in local]
                term = []
                if gathered:
                    term.append((gathered, *self._run_group(self._gather(gathered, c), gathered,
                                                            y_all, bias_losses)))
                if filled:
                    kind = ("i16" if paths_ref is None
                            and all(entries[i][0] == "native" for i in filled) else "f32")
                    segs = self._batch(filled, paths, paths_ref, entries, entries_ref,
                                       batch_size, kind)
                    term.append((filled, *self._run_group(segs, filled, y_all, bias_losses)))
                terms.append(term)
            if verbose == 2:
                print(f"\r{100 * (b + 1) / n_batches:3.0f}%, {b + 1}/{n_batches}, "
                      f"{time.perf_counter() - t0:.0f}s", end="", file=sys.stderr, flush=True)
        if verbose == 2:
            print(file=sys.stderr, flush=True)

        # the epoch's one readback
        steps = [s for term in terms for s in term]
        losses = iter(torch.stack([loss for _, loss, _ in steps]).cpu().tolist())
        y_hats = torch.cat([y for _, _, y in steps]).float().cpu().numpy()
        y_hat_all = np.zeros((n_files, n_targets), dtype=np.float32)
        pos = 0
        for g, _, _ in steps:
            y_hat_all[g] = y_hats[pos : pos + len(g)]
            pos += len(g)
        rows_losses = [[(len(g), next(losses)) for g, _, _ in term] for term in terms]
        term_losses = [parts[0][1] if len(parts) == 1
                       else sum(n * loss for n, loss in parts) / sum(n for n, _ in parts)
                       for parts in rows_losses]
        self.history.append({"epoch": epoch, "steps": len(steps), "files": n_files,
                             "wall_s": time.perf_counter() - t0, "terms": rows_losses,
                             "build_s": self.build_s})
        return sum(term_losses) / max(len(term_losses), 1), y_hat_all


# ---------------------------------------------------------------------------
# results CSV + checkpoints
# ---------------------------------------------------------------------------


class ResultsWriter:
    """The per-epoch results CSV (every value stringified, in the JAX
    package's column order) and the checkpoints of ``tr_checkpoint``:
    ``every_epoch`` (``<runname>__ep_<NNN>``) or ``best_only``
    (``<runname>``, when the early stopper flags the epoch best)."""

    def __init__(self, runner, runname):
        self.runner = runner
        self.runname = runname
        self.rows = []

    def save(self, epoch, loss, ep_runtime, r, bias_b, optimizer, best, sched, stopper):
        runner = self.runner
        args = runner.args
        ckpt_mode = args.get("tr_checkpoint", "every_epoch")
        if ckpt_mode not in ("every_epoch", "best_only"):
            raise ValueError("selected tr_checkpoint option not available")
        base = self.runname if ckpt_mode == "best_only" else f"{self.runname}__ep_{epoch + 1:03d}"
        run_dir = os.path.join(args["output_dir"], self.runname)
        os.makedirs(run_dir, exist_ok=True)

        results = {
            "runname": self.runname,
            "epoch": f"{epoch + 1:05d}",
            "filename": base + ".tar",
            "loss": loss,
            "ep_runtime": f"{ep_runtime:0.2f}",
            **runner.runinfos,
            **r,
            **{k: v for k, v in args.items() if k != "now"},
        }
        results = {k: str(v) for k, v in results.items()}
        self.rows.append(results)
        cols = list(dict.fromkeys(k for row in self.rows for k in row))
        table = Table({c: np.array([row.get(c) for row in self.rows], dtype=object) for c in cols})
        table.to_csv(os.path.join(run_dir, self.runname + "__results.csv"))

        if ckpt_mode == "every_epoch" or best:
            save_train_state(os.path.join(run_dir, base), runner.model, optimizer, args, epoch,
                             bias_b, results,
                             {"sched": sched.state_dict(), "stopper": stopper.state_dict()})


# ---------------------------------------------------------------------------
# MOS training
# ---------------------------------------------------------------------------


def _maybe_resume(runner, engine, bias_losses, sched, stopper):
    """Full train-state resume (``tr_resume``: a checkpoint's base path, with
    or without its suffix): weights and BN statistics, Adam's moments, the
    bias-loss coefficients, the epoch, and the LR-plateau and early-stopper
    state. Returns the epoch to start from."""
    base = runner.args.get("tr_resume")
    if not base:
        return 0
    for suffix in (".tar", ".pt", ".msgpack"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    state = load_train_state(base)
    runner.model.load_state_dict(state["model_state_dict"], strict=True)
    engine.opt.load_state_dict(state["optimizer"])
    bias_b = state["bias_b"].numpy()  # (N, 4), or (N, K, 4) for K > 1 targets
    for k, bl in enumerate(bias_losses):
        bl.b = (bias_b[:, k] if len(bias_losses) > 1 else bias_b).copy()
    sched.load_state_dict(state["loop_state"]["sched"])
    stopper.load_state_dict(state["loop_state"]["stopper"])
    start = int(state["epoch"])
    print(f"--> resumed from {base} at epoch {start}")
    return start


def _bias_losses(runner, k):
    args = runner.args
    return [
        BiasLoss(
            runner.ds_train.df["db"],
            anchor_db=args.get("tr_bias_anchor_db"),
            mapping=args.get("tr_bias_mapping"),
            min_r=args.get("tr_bias_min_r"),
            do_print=(args.get("tr_verbose", 0) > 0),
        )
        for _ in range(k)
    ]


def _validate(runner, engine):
    """The validation pass through the serving engine (which runs it in
    eval mode and restores the model's mode); its wall time goes to the
    epoch's history entry."""
    t0 = time.perf_counter()
    y_val_hat = runner._engine().predict_paths(runner.ds_val.paths(), runner.ds_val.paths_ref())
    engine.history[-1]["val_s"] = time.perf_counter() - t0
    runner.ds_val.write_predictions(y_val_hat)


def _setup(runner, stopper_cls, k):
    args = runner.args
    runname = runner._make_runname_and_write_yaml()
    engine = runner.train_engine = TrainEngine(runner)
    sched = ReduceLROnPlateau(args["tr_lr"], args["tr_lr_patience"])
    stopper = stopper_cls(args["tr_early_stop"])
    bias_losses = _bias_losses(runner, k)
    start_epoch = _maybe_resume(runner, engine, bias_losses, sched, stopper)
    return engine, sched, stopper, bias_losses, ResultsWriter(runner, runname), start_epoch


def train_mos(runner):
    args = runner.args
    engine, sched, stopper, bias_losses, writer, start_epoch = _setup(runner, EarlyStopper, 1)
    verbose = args.get("tr_verbose", 0)

    print("--> start training")
    for epoch in range(start_epoch, args["tr_epochs"]):
        tic = time.time()
        loss, y_hat = engine.run_epoch(runner.ds_train, bias_losses, sched.lr, epoch,
                                       args["tr_bs"], verbose=verbose)
        y_train = np.asarray(runner.ds_train.df[args["csv_mos_train"]], dtype=np.float64)
        bias_losses[0].update_bias(y_train, y_hat[:, 0])

        if verbose > 0:
            print("\n<---- Training ---->")
        runner.ds_train.df["mos_pred"] = y_hat[:, 0].astype(float)
        _, r_train = eval_results(
            runner.ds_train.df, dcon=runner.ds_train.df_con,
            target_mos=args["csv_mos_train"], target_ci=args["csv_mos_train"] + "_ci",
            pred="mos_pred", mapping="first_order", do_print=(verbose > 0),
        )

        if verbose > 0:
            print("<---- Validation ---->")
        _validate(runner, engine)
        _, r_val = eval_results(
            runner.ds_val.df, dcon=runner.ds_val.df_con,
            target_mos=args["csv_mos_val"], target_ci=args["csv_mos_val"] + "_ci",
            pred="mos_pred", mapping="first_order", do_print=(verbose > 0),
        )

        r = {
            "train_r_p_mean_file": r_train["r_p_mean_file"],
            "train_rmse_map_mean_file": r_train["rmse_map_mean_file"],
            **r_val,
        }
        lr_now = sched.lr
        sched.step(loss)
        stop = stopper.step(r)
        ep_runtime = time.time() - tic
        print(
            f"ep {epoch + 1} sec {ep_runtime:0.0f} es {stopper.cnt} lr {lr_now:0.0e} "
            f"loss {loss:0.4f} // r_p_tr {r['train_r_p_mean_file']:0.2f} "
            f"rmse_map_tr {r['train_rmse_map_mean_file']:0.2f} // "
            f"r_p {r['r_p_mean_file']:0.2f} rmse_map {r['rmse_map_mean_file']:0.2f} // "
            f"best_r_p {stopper.best_r_p:0.2f} best_rmse_map {stopper.best_rmse:0.2f}"
        )
        writer.save(epoch, loss, ep_runtime, r, bias_losses[0].b, engine.opt, stopper.best, sched,
                    stopper)
        if stop:
            print(f"--> Early stopping. best_r_p {stopper.best_r_p:0.2f} "
                  f"best_rmse {stopper.best_rmse:0.2f}")
            return
    print(f"--> Training done. best_r_p {stopper.best_r_p:0.2f} "
          f"best_rmse_map {stopper.best_rmse:0.2f}")


# ---------------------------------------------------------------------------
# Multidimensional training
# ---------------------------------------------------------------------------

_DIM = ("mos", "noi", "dis", "col", "loud")


def train_dim(runner):
    args = runner.args
    engine, sched, stopper, bias_losses, writer, start_epoch = _setup(runner, EarlyStopperDim, 5)
    verbose = args.get("tr_verbose", 0)

    print("--> start training")
    for epoch in range(start_epoch, args["tr_epochs"]):
        tic = time.time()
        loss, y_hat = engine.run_epoch(runner.ds_train, bias_losses, sched.lr, epoch,
                                       args["tr_bs"], verbose=verbose)
        y_train = runner.ds_train.targets()
        for k in range(5):
            bias_losses[k].update_bias(y_train[:, k], y_hat[:, k])

        if verbose > 0:
            print("\n<---- Training ---->")
        runner.ds_train.write_predictions(y_hat)
        r_train = {}
        for t in _DIM:
            if verbose > 0:
                print(f"--> {t.upper()}:")
            _, rt = eval_results(
                runner.ds_train.df, dcon=runner.ds_train.df_con, target_mos=t,
                target_ci=f"{t}_ci", pred=f"{t}_pred", mapping="first_order",
                do_print=(verbose > 0),
            )
            suffix = "" if t == "mos" else f"_{t}"
            r_train[f"train_r_p_mean_file{suffix}"] = rt["r_p_mean_file"]
            r_train[f"train_rmse_map_mean_file{suffix}"] = rt["rmse_map_mean_file"]

        if verbose > 0:
            print("<---- Validation ---->")
        _validate(runner, engine)
        r_val = {}
        for t in _DIM:
            if verbose > 0:
                print(f"--> {t.upper()}:")
            _, rv = eval_results(
                runner.ds_val.df, dcon=runner.ds_val.df_con, target_mos=t,
                target_ci=f"{t}_ci", pred=f"{t}_pred", mapping="first_order",
                do_print=(verbose > 0),
            )
            suffix = "" if t == "mos" else f"_{t}"
            r_val.update({f"{k}{suffix}": v for k, v in rv.items()})

        r = {**r_train, **r_val}
        lr_now = sched.lr
        sched.step(loss)
        stop = stopper.step(r)
        ep_runtime = time.time() - tic
        r_dim_mean = np.mean([r[f"r_p_mean_file{'' if t == 'mos' else '_' + t}"] for t in _DIM])
        print(
            f"ep {epoch + 1} sec {ep_runtime:0.0f} es {stopper.cnt} lr {lr_now:0.0e} "
            f"loss {loss:0.4f} // r_p_tr {r['train_r_p_mean_file']:0.2f} "
            f"rmse_map_tr {r['train_rmse_map_mean_file']:0.2f} // "
            f"r_dim_mos_mean {r_dim_mean:0.2f}, r_p {r['r_p_mean_file']:0.2f} "
            f"rmse_map {r['rmse_map_mean_file']:0.2f} // "
            f"best_r_p {stopper.best_r_p_mos:0.2f} best_rmse_map {stopper.best_rmse_mos:0.2f}"
        )
        writer.save(epoch, loss, ep_runtime, r, np.stack([bl.b for bl in bias_losses], axis=1),
                    engine.opt, stopper.best, sched, stopper)
        if stop:
            print(f"--> Early stopping. best_r_p {stopper.best_r_p_mos:0.2f} "
                  f"best_rmse {stopper.best_rmse_mos:0.2f}")
            return
    print(f"--> Training done. best_r_p {stopper.best_r_p_mos:0.2f} "
          f"best_rmse {stopper.best_rmse_mos:0.2f}")
