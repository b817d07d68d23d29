"""Single-file requests in an open loop (a quality monitor scoring
recordings as they arrive): arrivals at a fixed mean rate, each request one
call of the predictor on one file of a pool, served in arrival order.

Every seed gets the same gaps between arrivals, in another order: the
``n = rate x seconds`` evenly spaced quantiles of the exponential
distribution, permuted by the seed and scaled so that the last request is
due at the window's close; the files cycle through a seeded permutation of
the pool. A request's latency runs from when it was due to when its answer
is on the host. Requests still unanswered a minute after the close have
failed, and count as misses at that time.

End to end: ``request_p95_ms`` over every request due in the window, and
``setup_s``. Correct: every answer against the reference (``pred_gap``).
"""

from __future__ import annotations

import time

import numpy as np

from ..corpus import seed_stream
from ..trace import Tracer
from .scoring import Outcome, Scoring

GRACE_S = 60.0


def schedule(n: int, rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``n`` requests."""
    q = (np.arange(n) + 0.5) / n
    gaps = np.random.default_rng(seed).permutation(-np.log1p(-q) / rate)
    due = np.cumsum(gaps)
    return due * (seconds / due[-1])


def setup(ctx):
    sc = Scoring(ctx, int(ctx.traffic["pool_files"]))
    sc.engine.warmup(sc.paths)
    sc.call(sc.paths[:1])
    return sc


def window(ctx, sc, rate: float, tracer) -> dict:
    """One open-loop window at ``rate`` requests a second."""
    n = max(1, int(round(rate * ctx.seconds)))
    due = schedule(n, rate, ctx.seconds, seed_stream(ctx.seed, 4))
    order = np.random.default_rng(seed_stream(ctx.seed, 5)).permutation(len(sc.paths))
    files = np.resize(order, n)
    end = np.full(n, np.nan)
    answers, dispatch = [], []
    tracer.start()
    t0 = time.perf_counter()
    for k in range(n):
        t_due = t0 + due[k]
        wait = t_due - time.perf_counter()
        if wait > 0:
            with tracer.span("bench.wait"):
                if wait > 1e-3:
                    time.sleep(wait - 5e-4)
                while time.perf_counter() < t_due:
                    pass
        if time.perf_counter() > t0 + ctx.seconds + GRACE_S:
            break
        with tracer.span("bench.request"):
            answers.append(sc.call([sc.paths[files[k]]]))
        end[k] = time.perf_counter()
        dispatch.append(sc.engine.stats["last"].get("dispatch_s", 0.0))
    tracer.stop()
    done = ~np.isnan(end)
    t_due = t0 + due
    lat = np.where(done, end - t_due, t0 + ctx.seconds + GRACE_S - t_due)

    def backlog(t):
        return int(np.sum((t_due <= t) & ~(end <= t)))

    return {"n": n, "completed": int(done.sum()), "files": files[done],
            "answers": np.concatenate(answers) if answers else np.zeros((0, sc.heads)),
            "latency_s": lat, "dispatch_s": dispatch, "t0": t0,
            "in_window": int(np.sum(end <= t0 + ctx.seconds)),
            "backlog_mid": backlog(t0 + ctx.seconds / 2), "backlog_end": backlog(t0 + ctx.seconds)}


def run(ctx):
    sc = setup(ctx)
    tracer = Tracer(ctx.trace, ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    w = window(ctx, sc, float(ctx.traffic["rate_per_s"]), tracer)

    def check():
        return [("pred_gap", sc.gap(w["answers"], w["files"]), ctx.limits["pred_gap"])]

    return Outcome(release=sc.release,
                   e2e={"setup_s": setup_s,
                        "request_p95_ms": float(np.percentile(w["latency_s"], 95)) * 1e3},
                   attempted=w["n"], failed=w["n"] - w["completed"], trace=tracer.summary,
                   window=w, check=check, precision=ctx.config["precision"], scoring=sc)
