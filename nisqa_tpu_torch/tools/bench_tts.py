"""NISQA-TTS serving benchmark: predict_dir throughput at the TTS checkpoint geometry.

Counterpart of the bench mode of ``tools/bench_tts.py``. The released
NISQA-TTS weights (``tests/goldens/g3_tts.npz``: StandardCNN + fc 20 ->
bidirectional LSTM -> ``last_step_bi``) at their checkpoint's front-end
(seg_hop 1, up to 6,000 segments, fmax 8 kHz) serve ``corpus.tts_corpus``
(16 files of 10-40 s at 48 kHz) at bs 8: ``warmup``, then 5 fetched passes
(pass 0 cold, the rest cached). The engine runs the LSTM model at
"highest" (float32, TF32 off), so the MFU's peak is the card's FP32 rate.
The headline ``value`` is the best pass. The record adds, as
``tools.bench``'s does, the FLOP count (the LSTM's gate products over every
step of the bucket counted), MFU, idle shares, peak memory and launches.
The original's parity mode needs the reference NISQA and is not here.

Usage: python -m nisqa_tpu_torch.tools.bench_tts [--files 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from ..model import resolve_device
from . import corpus, measure


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nisqa_tpu_torch.tools.bench_tts",
                                 description=__doc__.split("\n")[0])
    measure.device_args(ap)
    ap.add_argument("--files", type=int, default=16, help="corpus size")
    ap.add_argument("--corpus-dir", help="where the corpus is written or reused")
    ap.add_argument("--tar", help="checkpoint to serve (default: g3_tts.npz's weights at the TTS "
                                  "geometry)")
    ap.add_argument("--bs", type=int, default=8, help="batch size")
    ap.add_argument("--passes", type=int, default=5, help="fetched passes, the first cold")
    return ap.parse_args(argv)


def run(opts) -> dict:
    device = resolve_device(opts.device)
    audio_s, paths = corpus.tts_corpus(
        opts.corpus_dir or corpus.default_dir(f"tts_corpus_{opts.files}"), opts.files)
    with tempfile.TemporaryDirectory(prefix="nisqa_bench_tts_") as tmp:
        tar = opts.tar or corpus.golden_tar("g3_tts", corpus.TTS_GEOMETRY,
                                            os.path.join(tmp, "nisqa_tts.tar"), "NISQA_TTS")
        rec = measure.bench_serving(
            tar, paths, None, audio_s, device, batch_size=opts.bs, passes=opts.passes,
            devrate_passes=0, async_blocks=0, headline="fetched")
    return {"metric": f"predict_dir_throughput_nisqa_tts_bs{opts.bs}", **rec,
            "n_files": opts.files}


def main(argv=None) -> dict:
    rec = run(parse_args(argv))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
