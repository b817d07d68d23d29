"""The request cell's knee: the open loop at several rates in one process.

    python3 benchmark/sweep_rate.py --workload dim_files_open --seed 7 --seconds 30 --rates 50,100,200

For each rate it prints one JSON line: the requests due in the window, the
share answered inside it, the backlog at the window's middle and at its
close, and the latencies' median and 95th percentile (ms). A rate is
sustained when at least 99% of the requests due in the window are answered
inside it and the backlog at the close is no longer than at the middle.
The cell runs at four fifths of the highest sustained rate, written into
``traffic/<mix>.json`` as ``rate_per_s``; the benchmark's runs never sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/sweep_rate.py")
    ap.add_argument("--workload", default="dim_files_open")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    opts = ap.parse_args(argv)
    harness.cache_env()
    import numpy as np
    import torch

    from benchmark.drivers import open_loop
    from benchmark.trace import Tracer

    cell = harness.Cell(opts.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    tmp = tempfile.mkdtemp(prefix="sweep_")
    try:
        ctx = harness.Ctx(cell, opts.seed, opts.seconds, False, device, time.perf_counter(), tmp)
        sc = open_loop.setup(ctx)
        for rate in (float(r) for r in opts.rates.split(",")):
            w = open_loop.window(ctx, sc, rate, Tracer(False, device))
            lat = w["latency_s"] * 1e3
            rec = {"rate_per_s": rate, "due": w["n"], "answered_in_window": w["in_window"] / w["n"],
                   "backlog_mid": w["backlog_mid"], "backlog_end": w["backlog_end"],
                   "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                   "failed": w["n"] - w["completed"]}
            rec["sustained"] = (rec["answered_in_window"] >= 0.99 and rec["failed"] == 0
                                and w["backlog_end"] <= w["backlog_mid"])
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
