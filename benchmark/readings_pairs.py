"""The readings that ``de_corpus_cold``'s limit is set from, in one process.

    python3 benchmark/readings_pairs.py --seeds 11,12,13 [--seconds 3] [--precision highest]

For each seed it runs the cell as a run does (set-up, a short window of the
timed path at the cell's sizes, the comparison with the reference) and
prints one JSON line: the program's ``pred_gap`` (a lower reading: a sound
run), and the same number of the two controls put in the program's place,
each against the float32 reference over every pair of the corpus:

  * ``bf16``: the reference in bfloat16, the precision below the
    configuration's (TF32 products with bfloat16 DFT operands);
  * ``align_skipped``: the float32 reference with the alignment left out,
    the reference end's features fused unaligned (a planted fault).

``--precision`` serves the program at another precision than the
configuration's, to compare the two. The benchmark's own runs never run
this (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/readings_pairs.py")
    ap.add_argument("--workload", default="de_corpus_cold")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", choices=("default", "highest"))
    ap.add_argument("--pairs", type=int, help="fewer pairs than the cell's (a quick look)")
    opts = ap.parse_args(argv)
    harness.cache_env()
    import torch

    from benchmark.drivers import pair_passes

    cell = harness.Cell(opts.workload)
    if opts.precision:
        cell.config["precision"] = opts.precision
    if opts.pairs:
        cell.traffic["pairs"] = opts.pairs
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in opts.seeds.split(",")):
        tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"readings_{os.getpid()}_{seed}")
        os.makedirs(tmp)
        t0 = time.perf_counter()
        out = pair_passes.run(harness.Ctx(cell, seed, opts.seconds, False, device, t0, tmp))
        out.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        sc = out.scoring
        files = list(range(len(sc.paths)))
        y_ref = sc.reference(files)
        rec = {"seed": seed, "precision": cell.config["precision"],
               "program": {n: v for n, v, _ in out.check()}, "e2e": out.e2e,
               "control": {"bf16": sc.gap(sc.reference(files, torch.bfloat16), files),
                           "align_skipped": sc.gap(sc.reference(files, skip_align=True), files)},
               "ref_spread": float(y_ref.max() - y_ref.min())}
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
        del out, sc
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
