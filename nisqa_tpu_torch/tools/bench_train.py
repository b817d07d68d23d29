"""Training throughput: train audio-s/s of NISQA from scratch, per epoch.

Counterpart of ``tools/bench_train.py``. NISQA with the architecture and
front-end of the released ``nisqa_mos_only.tar`` (``tests/goldens/
g1_mos_only.npz``'s model args at the yaml geometry; ``--tts``: NISQA-TTS,
``g3_tts.npz``'s at the TTS geometry over ``corpus.tts_corpus``) trains from
a fresh seeded model over ``corpus.bench_corpus`` (96 files by default):
the first 5/6 of the files db ``train``, the rest ``val``, MOS uniform in
[1, 5] from seed 0 or, with ``--learnable``, from each file's pitch. It runs
the original's training args (Adam at lr 1e-3, bs 32, TTS bs 8; the
device-resident corpus, ``tr_ds_to_memory``, on) through
``NisqaTorch(args).train()``, the same loop as ``run_train``, each epoch
with its validation pass.

Each epoch's time is ``TrainEngine.run_epoch``'s wall (its history), the
train step loop and the epoch's readback; the headline ``value`` is the
train split's audio seconds over the best epoch after the first (which
builds the device corpus). After training, one more epoch runs under
``torch.profiler`` for the warm epoch's device idle share. The final
validation r_p and RMSE come from the run's results CSV. The record has the
original's keys without ``vs_baseline`` (a CPU rate of another host), and
adds the idle share, the kernel's launches, peak device memory and every
epoch's time.

Usage: python -m nisqa_tpu_torch.tools.bench_train [--files 96] [--epochs 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from ..compat.checkpoint import load_torch_checkpoint
from ..data.dataset import Table
from ..model import resolve_device
from ..ops.dft_mel import fused_dft_mel
from . import corpus, measure


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.tools.bench_train",
                                 description=__doc__.split("\n")[0])
    measure.device_args(ap)
    ap.add_argument("--files", type=int, help="corpus size (default 96; --tts 16)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--bs", type=int, help="train and validation batch size (default 32; --tts 8)")
    ap.add_argument("--precision", choices=("default", "highest"), default="highest",
                    help="tr_precision")
    ap.add_argument("--learnable", action="store_true",
                    help="MOS from each file's pitch, so the final r_p and RMSE mean something")
    ap.add_argument("--cache-mb", type=float,
                    help="tr_device_cache_mb (default max(1024, files * 6), --tts * 24); below the "
                         "corpus's mel rows it measures partial residency")
    ap.add_argument("--tts", action="store_true", help="NISQA-TTS over the TTS corpus")
    ap.add_argument("--corpus-dir", help="where the corpus is written or reused")
    ap.add_argument("--arch-tar", help="take the architecture and front-end from this checkpoint's "
                                       "args instead of the golden's")
    return ap.parse_args(argv)


def train_args(opts, corpus_dir: str, out_dir: str, n_files: int, bs: int) -> dict:
    if opts.arch_tar:
        base = load_torch_checkpoint(opts.arch_tar)["args"]
    else:
        meta, _ = corpus.load_golden("g3_tts" if opts.tts else "g1_mos_only")
        base = {**meta["model_args"],
                **(corpus.TTS_GEOMETRY if opts.tts else corpus.YAML_GEOMETRY)}
    cache_mb = opts.cache_mb if opts.cache_mb is not None else max(1024, n_files * (24 if opts.tts
                                                                                    else 6))
    return {**base, "mode": "main", "name": "trbench", "model": "NISQA",
            "pretrained_model": False, "data_dir": corpus_dir, "output_dir": out_dir,
            "csv_file": "train_bench.csv", "csv_deg": "deg", "csv_mos_train": "mos",
            "csv_mos_val": "mos", "csv_db_train": ["train"], "csv_db_val": ["val"],
            "csv_con": None, "csv_ref": None, "tr_epochs": opts.epochs, "tr_early_stop": 50,
            "tr_bs": bs, "tr_bs_val": bs, "tr_lr": 1e-3, "tr_lr_patience": 15,
            "tr_num_workers": 8, "tr_parallel": False, "tr_checkpoint": "best_only",
            "tr_verbose": 0, "tr_bias_mapping": None, "tr_bias_min_r": None,
            "tr_bias_anchor_db": None, "tr_ds_to_memory": True, "tr_device_cache_mb": cache_mb,
            "tr_precision": opts.precision, "tr_device": opts.device, "seed": 0}


def write_csv(corpus_dir: str, paths, n_train: int, learnable: bool):
    """``train_bench.csv`` beside the corpus (written under a temporary name, then renamed)."""
    names = [os.path.basename(p) for p in paths]
    mos = (corpus.learnable_mos(paths) if learnable
           else np.random.default_rng(0).uniform(1.0, 5.0, len(names)).round(2))
    table = Table({"deg": np.array(names, dtype=object),
                   "db": np.array(["train"] * n_train + ["val"] * (len(names) - n_train),
                                  dtype=object),
                   "mos": mos})
    path = os.path.join(corpus_dir, "train_bench.csv")
    table.to_csv(f"{path}.{os.getpid()}.part")
    os.replace(f"{path}.{os.getpid()}.part", path)


def final_val(out_dir: str) -> dict:
    """The last epoch's validation r_p and RMSE from the results CSV of the
    run in ``out_dir`` (None where undefined, e.g. r_p over a single
    validation file)."""
    for d in os.listdir(out_dir):
        path = os.path.join(out_dir, d, d + "__results.csv")
        if os.path.isfile(path):
            t = Table.read_csv(path)
            vals = {"final_val_r_p": float(t["r_p_mean_file"][-1]),
                    "final_val_rmse_map": float(t["rmse_map_mean_file"][-1])}
            return {k: v if math.isfinite(v) else None for k, v in vals.items()}
    raise FileNotFoundError(f"no results CSV under {out_dir}")


def run(opts) -> dict:
    from ..model import NisqaTorch
    from ..train.loop import _bias_losses, _n_of

    device = resolve_device(opts.device)
    n_files = opts.files or (16 if opts.tts else 96)
    bs = opts.bs or (8 if opts.tts else 32)
    if opts.tts:
        corpus_dir = opts.corpus_dir or corpus.default_dir(f"tts_corpus_{n_files}")
        _, paths = corpus.tts_corpus(corpus_dir, n_files)
    else:
        corpus_dir = opts.corpus_dir or corpus.default_dir(f"bench_corpus_{n_files}")
        _, paths = corpus.bench_corpus(corpus_dir, n_files)
    n_train = n_files * 5 // 6
    write_csv(corpus_dir, paths, n_train, opts.learnable)

    with tempfile.TemporaryDirectory(prefix="nisqa_bench_train_") as out_dir:
        args = train_args(opts, corpus_dir, out_dir, n_files, bs)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        fused_dft_mel.LAUNCHES = 0
        tic = time.perf_counter()
        runner = NisqaTorch(args)
        runner.train()
        wall = time.perf_counter() - tic
        launches = fused_dft_mel.LAUNCHES
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        final = final_val(out_dir)

        eng = runner.train_engine
        epoch_s = [h["wall_s"] for h in eng.history]
        train_audio_s = sum(_n_of(e) / e[2] for e in eng._entries(runner.ds_train.paths()))
        bias = _bias_losses(runner, 1)
        idle = measure.idle_of(lambda: eng.run_epoch(runner.ds_train, bias, args["tr_lr"],
                                                     len(eng.history), bs), device)
    best = min(epoch_s[1:]) if len(epoch_s) > 1 else epoch_s[0]
    measure.log(f"epochs: {eng.history}")
    return {
        "metric": f"train_epoch_throughput_nisqa{'_tts' if opts.tts else ''}_bs{bs}",
        "value": train_audio_s / best,
        "unit": "audio-sec/sec/chip",
        "epoch_sec_best": best,
        "epoch_sec": epoch_s,
        "corpus_build_s": eng.history[0]["build_s"],
        "steps_per_epoch": eng.history[0]["steps"],
        "files": n_files,
        "train_audio_s": train_audio_s,
        "tr_device_cache_mb": args["tr_device_cache_mb"],
        "tr_precision": opts.precision,
        f"full_loop_sec_{opts.epochs}ep": wall,
        **final,
        "idle_warm_epoch": idle,
        "launches": launches,
        "max_memory_allocated_gb": None if peak is None else peak / 1e9,
        "device": measure.card(device),
    }


def main(argv=None) -> dict:
    rec = run(parse_args(argv))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
