"""NISQA_DE serving benchmark: throughput over degraded / reference pairs.

Counterpart of the bench mode of ``tools/bench_de.py``. The trained
double-ended weights ``tests/goldens/de_trained.tar`` (the shipped DE
architecture: AdaptCNN -> 2 x SA -> cosine / hard alignment -> x/y/-
fusion -> 2 x SA -> PoolAttFF) serve ``corpus.de_corpus`` (96 pairs of 8 s
at 48 kHz) at bs 32 and at the original's precision, "default", in
``tools.bench``'s order: ``warmup``, 7 fetched passes (pass 0 cold, two
kernel launches per batch, one per end), 3 fetch-free and 3 blocks of 8
async cached passes; the headline ``value`` is the best async pass. Rates
count the degraded end's audio seconds, as the original's do, though a
pass front-ends both ends. The record has the original's keys
(``fetched_median`` is the median of the cached fetched passes) and
``tools.bench``'s: MFU, idle shares, peak memory and launches. Training
the weights is ``python -m nisqa_tpu_torch.run_train --yaml
nisqa_tpu/config/train_nisqa_double_ended.yaml``; the parity mode needs the
reference NISQA. Neither is here.

Usage: python -m nisqa_tpu_torch.tools.bench_de [--pairs 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from ..model import resolve_device
from . import corpus, measure

DE_TAR = os.path.join(corpus.GOLDENS, "de_trained.tar")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.tools.bench_de",
                                 description=__doc__.split("\n")[0])
    measure.device_args(ap)
    ap.add_argument("--pairs", type=int, default=96, help="degraded / reference pairs "
                                                          "(the original's NISQA_DE_PAIRS)")
    ap.add_argument("--corpus-dir", help="where the corpus is written or reused")
    ap.add_argument("--tar", default=DE_TAR, help="NISQA_DE checkpoint to serve")
    ap.add_argument("--bs", type=int, default=32, help="batch size")
    ap.add_argument("--passes", type=int, default=7, help="fetched passes, the first cold")
    ap.add_argument("--devrate-passes", type=int, default=3, help="fetch-free cached passes")
    ap.add_argument("--async-blocks", type=int, default=3, help="blocks of async cached passes")
    ap.add_argument("--async-depth", type=int, default=8, help="async passes dispatched per block")
    return ap.parse_args(argv)


def run(opts) -> dict:
    device = resolve_device(opts.device)
    audio_s, deg, ref, _ = corpus.de_corpus(
        opts.corpus_dir or corpus.default_dir(f"de_corpus_{opts.pairs}"), opts.pairs)
    rec = measure.bench_serving(
        opts.tar, deg, ref, audio_s, device, batch_size=opts.bs, precision="default",
        cache_mb=max(512, opts.pairs * 8), passes=opts.passes,
        devrate_passes=opts.devrate_passes, async_blocks=opts.async_blocks,
        async_depth=opts.async_depth)
    return {"metric": f"predict_de_throughput_bs{opts.bs}", **rec,
            "fetched_median": rec["fetched_cached_median"], "n_pairs": opts.pairs}


def main(argv=None) -> dict:
    rec = run(parse_args(argv))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
