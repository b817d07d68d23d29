"""Repeated passes of the predictor over one corpus (a user scoring a
directory): set-up writes the corpus, loads the checkpoint, warms the
corpus's shapes and makes one pass; the window makes passes until one ends
at or after its close, and spans from its start to the end of the last.

End to end: ``score_audio_s_per_s``, the corpus's audio seconds times the
passes over the window, and ``setup_s``. Correct: every answer of every
pass in the window against the reference (``pred_gap``)."""

from __future__ import annotations

import time

import numpy as np

from ..trace import Tracer
from .scoring import Outcome, Scoring


def run(ctx):
    sc = Scoring(ctx, int(ctx.traffic["files"]))
    sc.engine.warmup(sc.paths)
    sc.call(sc.paths)
    tracer = Tracer(ctx.trace, ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    answers, stats = [], []
    tracer.start()
    t0 = time.perf_counter()
    while True:
        with tracer.span("bench.pass"):
            answers.append(sc.call(sc.paths))
        stats.append(dict(sc.engine.stats["last"]))
        t1 = time.perf_counter()
        if t1 - t0 >= ctx.seconds:
            break
    tracer.stop()
    window = t1 - t0
    passes = len(answers)
    fast = sc.engine.fe_precision == "fast"
    work = {k: v * passes for k, v in sc.tally.of(sc.n_samples, fast).items()}
    n = len(sc.paths)

    def check():
        return [("pred_gap", sc.gap(np.concatenate(answers), np.tile(np.arange(n), passes)),
                 ctx.limits["pred_gap"])]

    return Outcome(release=sc.release, e2e={"setup_s": setup_s,
                                            "score_audio_s_per_s": sc.audio_s * passes / window},
                   attempted=passes * n, failed=0, stats=stats, trace=tracer.summary, work=work,
                   window_s=window, precision=ctx.config["precision"], fast=fast,
                   check=check, scoring=sc)
