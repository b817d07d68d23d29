"""Training loops (MOS and multidimensional) on one device.

Counterpart of ``nisqa_tpu/train/loop.py`` with the per-batch host fill:
Adam, reduce-on-plateau (relative threshold 0.003), early stopping and the
optional bias loss; the train-mode predictions of each epoch feed the
train-set metrics, a validation pass through the serving engine follows
every epoch, and each epoch writes a row of the results CSV and its
checkpoints.

One train step (:meth:`TrainEngine._run_group`), per batch and sample rate:

  host  : decode + reflect-pad the batch into a pinned staging slot (the
          i16 transport when every file is plain PCM16 mono and the model is
          single-ended, float32 otherwise), upload non_blocking, with the
          serving engine's fill and copy;
  device: ``mel_fn`` (the DFT->mel kernel in exact mode) and ``seg_fn`` under
          ``torch.no_grad()`` -- audio is data, no gradient reaches the
          front-end -- then the train-mode forward (masked batch norm,
          dropout), the loss, backward and ``torch.optim.Adam``.

Losses and predictions stay on the device until the epoch ends: a readback
per step would make the host fill wait for the device. Deliberate
differences from the JAX package: the shuffle order and the dropout masks
come from numpy and torch generators seeded from ``(seed, epoch)``, which
cannot reproduce JAX's PRNG; the full train state for ``tr_resume`` is a
``.pt`` file, not flax's ``.msgpack``; and there is no device-resident
corpus (``tr_ds_to_memory``) and no data parallelism (``tr_parallel``) yet:
both train as the host fill on one device does.
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


def _n_of(e):
    """Sample count of a transport entry: header-scanned entries carry n,
    decoded ones the samples."""
    return e[1] if e[0] in ("native", "native_f32") else len(e[1])


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
    """Train steps with the per-batch host fill, for the runner's model on
    its device. ``dft_mel`` is the front-end's DFT->mel step (the CUDA
    kernel for device tensors, its twin for CPU tensors)."""

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
        self.steps = 0  # train steps run (one per batch and sample rate)
        self.history = []  # per epoch: steps, files, wall_s (and val_s from the loop)
        if args.get("tr_parallel"):
            print("nisqa_tpu_torch: tr_parallel: data parallelism is not ported; "
                  "training runs on one device", file=sys.stderr)
        if args.get("tr_ds_to_memory"):
            print("nisqa_tpu_torch: tr_ds_to_memory: the device-resident corpus is not ported; "
                  "every epoch fills its batches from the host", file=sys.stderr)

    # -- host side -------------------------------------------------------------

    def _entries(self, paths):
        """Transport descriptors through the serving engine's header scan."""
        return self.runner._engine()._scan_transport(list(paths))

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

    # -- one step ----------------------------------------------------------------

    def _batch(self, idx, paths, paths_ref, entries, entries_ref, y_all, bias_losses, bs, kind):
        """Fill, upload and front-end one group of files (one sample rate):
        returns ([(segs, n_wins)] per end, targets (B, K), bias coefficients
        (B, K, 4)) on the device. The serving engine's ``_make_batch`` fills
        the slot (native decode, a file it misses decoded in Python) and its
        ``_upload`` copies it; the rows past the group are dropped."""
        ms = self.ms
        eng = self.runner._engine()
        sr = entries[idx[0]][2]
        ends = [(paths, entries)] + ([(paths_ref, entries_ref)] if paths_ref is not None else [])
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
            segs = [seg_fn(ms, sr, bucket, mel_fn(ms, sr, bucket, consts, audio, n, fast=False,
                                                  dft_mel=self.dft_mel), n)
                    for audio, n in blocks]
        y = torch.from_numpy(y_all[idx]).to(self.device)
        bias_b = np.stack([bl.coeffs(idx) for bl in bias_losses], axis=1)
        return segs, y, torch.from_numpy(bias_b).to(self.device)

    def _loss(self, segs, y, bias_b):
        """Train-mode forward and loss: (loss, predictions (B, K))."""
        if self.model.double_ended:
            y_hat = self.model.forward_ends(*segs[0], *segs[1])
        else:
            y_hat = self.model(*segs[0])
        return train_loss(y_hat, y, bias_b, self.loss_weight), y_hat

    def _run_group(self, idx, paths, paths_ref, entries, entries_ref, y_all, bias_losses, bs,
                   kind):
        segs, y, bias_b = self._batch(idx, paths, paths_ref, entries, entries_ref, y_all,
                                      bias_losses, bs, kind)
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
        mixed sample rates takes one step per rate). Returns (mean of the
        step losses, train-mode predictions (N, K) in dataset order)."""
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
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.model.train()

        results = []
        n_batches = -(-n_files // batch_size)
        for b, start in enumerate(range(0, n_files, batch_size)):
            by_sr = {}
            for i in order[start : start + batch_size]:
                by_sr.setdefault(entries[i][2], []).append(int(i))
            for g in by_sr.values():
                kind = ("i16" if paths_ref is None and all(entries[i][0] == "native" for i in g)
                        else "f32")
                loss, y_hat = self._run_group(g, paths, paths_ref, entries, entries_ref, y_all,
                                              bias_losses, batch_size, kind)
                results.append((g, loss, y_hat))
            if verbose == 2:
                print(f"\r{100 * (b + 1) / n_batches:3.0f}%, {b + 1}/{n_batches}, "
                      f"{time.perf_counter() - t0:.0f}s", end="", file=sys.stderr, flush=True)
        if verbose == 2:
            print(file=sys.stderr, flush=True)

        # the epoch's one readback
        losses = torch.stack([loss for _, loss, _ in results]).cpu().tolist()
        y_hats = torch.cat([y for _, _, y in results]).float().cpu().numpy()
        y_hat_all = np.zeros((n_files, n_targets), dtype=np.float32)
        pos = 0
        for g, _, _ in results:
            y_hat_all[g] = y_hats[pos : pos + len(g)]
            pos += len(g)
        self.history.append({"epoch": epoch, "steps": len(results), "files": n_files,
                             "wall_s": time.perf_counter() - t0})
        return sum(losses) / max(len(results), 1), y_hat_all


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
