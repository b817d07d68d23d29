"""Headline serving benchmark of the port: predict_dir throughput (audio-s/s per card).

Counterpart of ``bench.py`` at the repository root. The released NISQA_DIM
weights (``tests/goldens/g2_dim.npz``, written as a ``.tar`` at the yaml
geometry) serve ``corpus.bench_corpus`` (48 kHz, 3-30 s, 384 files by
default, about 4,500 audio-s) at bs 32 through the engine a user reaches by
``run_predict --mode predict_dir``, in ``bench.py``'s order: ``warmup``,
7 fetched passes (pass 0 cold: decode, upload, one DFT->mel kernel launch
per batch; passes 1-6 cached), 3 fetch-free cached passes (``fetch=False``)
and 3 blocks of 8 ``fetch="async"`` cached passes. The headline ``value``
is the best async pass.

The record (the last line of standard output) has ``bench.py``'s keys
without ``vs_baseline`` / ``vs_cached_cpu`` (CPU rates of another host):
``value``, ``*_best_pass`` / ``*_median`` / ``*_n`` per regime,
``cold_pass_rate``, ``flops_per_audio_s``, ``tflops_sustained``,
``peak_tflops``, ``mfu_pct`` and ``mfu_devrate_pct``; and beside them the
device idle share of one warm cached and one warm cold pass
(``torch.profiler``), the peak device memory of the regimes, the kernel's
launches in the cold pass and in the cached ones, and the cached passes'
largest difference from the cold pass. The FLOPs are
:mod:`.flops`'s count of the cached pass (every convolution tap, padding
included), counted before any pass is timed; the peak is the card's dense
rate at the pass's precision (``measure.PEAK_TFLOPS``: TF32 at "default",
FP32 at "highest").

Usage: python -m nisqa_tpu_torch.tools.bench [--files 384] [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from ..model import resolve_device
from . import corpus, measure


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.tools.bench",
                                 description=__doc__.split("\n")[0])
    measure.device_args(ap)
    ap.add_argument("--files", type=int, default=384,
                    help="corpus size (bench.py's NISQA_BENCH_FILES)")
    ap.add_argument("--corpus-dir", help="where the corpus is written or reused (default: a "
                                         "folder per size under the temporary directory)")
    ap.add_argument("--tar", help="checkpoint to serve (default: g2_dim.npz's weights at the "
                                  "yaml geometry)")
    ap.add_argument("--bs", type=int, default=32, help="batch size")
    ap.add_argument("--cache-mb", type=float,
                    help="corpus cache budget (default max(512, 6 * files)); 0 makes every pass cold")
    ap.add_argument("--passes", type=int, default=7, help="fetched passes, the first cold")
    ap.add_argument("--devrate-passes", type=int, default=3, help="fetch-free cached passes")
    ap.add_argument("--async-blocks", type=int, default=3, help="blocks of async cached passes")
    ap.add_argument("--async-depth", type=int, default=8, help="async passes dispatched per block")
    ap.add_argument("--devrate", action="store_true",
                    help="only the fetched passes, fetch-free after the first; the headline is "
                         "their best")
    ap.add_argument("--fe", choices=("exact", "fast"),
                    help="front-end mode (default: by precision)")
    ap.add_argument("--precision", choices=("default", "highest"), default="default")
    ap.add_argument("--no-fuse", action="store_true", help="cached passes batch by batch")
    ap.add_argument("--peak-tflops", type=float,
                    help="the MFU's peak (default: the H100's dense rate at the precision)")
    return ap.parse_args(argv)


def run(opts) -> dict:
    device = resolve_device(opts.device)
    audio_s, paths = corpus.bench_corpus(
        opts.corpus_dir or corpus.default_dir(f"bench_corpus_{opts.files}"), opts.files)
    with tempfile.TemporaryDirectory(prefix="nisqa_bench_") as tmp:
        tar = opts.tar or corpus.golden_tar("g2_dim", corpus.YAML_GEOMETRY,
                                            os.path.join(tmp, "nisqa_dim.tar"))
        rec = measure.bench_serving(
            tar, paths, None, audio_s, device, batch_size=opts.bs, precision=opts.precision,
            fe_precision=opts.fe, fuse_pass=False if opts.no_fuse else None,
            cache_mb=max(512, opts.files * 6) if opts.cache_mb is None else opts.cache_mb,
            passes=opts.passes, devrate_passes=opts.devrate_passes,
            async_blocks=opts.async_blocks, async_depth=opts.async_depth,
            devrate_only=opts.devrate, peak_tflops=opts.peak_tflops)
    metric = f"predict_dir_throughput_nisqa_dim_bs{opts.bs}"
    metric += "_devrate_nofetch" if opts.devrate else "_async_pipelined"
    return {"metric": metric, **rec, "n_files": opts.files}


def main(argv=None) -> dict:
    rec = run(parse_args(argv))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
