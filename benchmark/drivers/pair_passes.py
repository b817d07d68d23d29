"""Repeated passes of the double-ended predictor over one corpus of pairs (a
lab scoring degraded recordings against their clean sources): set-up writes
the pairs, loads the checkpoint, warms the corpus's shapes and makes one
pass; the window makes passes until one ends at or after its close, and
spans from its start to the end of the last (``corpus_passes``'s window).

End to end: ``score_audio_s_per_s``, the degraded ends' audio seconds times
the passes over the window (a scored pair is one scored recording), and
``setup_s``. Correct: every answer of every pass in the window against the
plain reference for that pair (``pred_gap``)."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import corpus, corpus_pairs
from ..counts.work_de import PairTally
from ..reference import nisqa_de_ref as de_ref
from ..reference import nisqa_ref as ref
from ..trace import Tracer
from ..weights import make_state
from .scoring import Outcome, Scoring


class PairScoring(Scoring):
    """A seeded corpus of pairs, seeded weights written as a reference-format
    ``.tar``, and ``load_predictor`` on it, as a user loads a checkpoint:
    :class:`.scoring.Scoring` with pairs in place of single files (its
    ``gap`` and ``release`` as they are)."""

    def __init__(self, ctx):
        t, cfg = ctx.traffic, ctx.config
        self.ctx, self.cfg, self.args, self.sr = ctx, cfg, cfg["args"], int(t["sr"])
        self.paths, self.paths_ref, self.pcm, self.pcm_ref = corpus_pairs.make(
            os.path.join(ctx.tmp, "pairs"), t, ctx.seed, ctx.device)
        self.n_deg = np.array([len(x) for x in self.pcm])
        self.n_ref = np.array([len(x) for x in self.pcm_ref])
        self.audio_s = float(self.n_deg.sum()) / self.sr
        self.state = make_state(de_ref.param_spec(self.args), corpus.seed_stream(ctx.seed, 3),
                                ctx.device, cfg["weights"])
        tar = os.path.join(ctx.tmp, "model.tar")
        torch.save({"args": {**self.args, "model": cfg["model"], "name": cfg["model"]},
                    "model_state_dict": {k: v.cpu() for k, v in self.state.items()},
                    "model_name": cfg["model"]}, tar)
        from nisqa_tpu_torch import load_predictor

        # the configuration's decode threads (the YAML's tr_num_workers)
        self.predict = load_predictor(tar, batch_size=int(t["batch_size"]), tr_device=ctx.device,
                                      precision=cfg["precision"], cache_mb=float(t["cache_mb"]),
                                      num_workers=int(self.args["tr_num_workers"]))
        self.engine = self.predict.engine
        self.tally = PairTally(self.args, self.sr)

    def call(self):
        """One pass over the pairs: (pairs, 1) on the host."""
        return self.predict(self.paths, self.paths_ref)

    def reference(self, files, dtype=torch.float32, skip_align: bool = False) -> np.ndarray:
        """The plain reference's (len(files), 1) for pairs ``files``, in
        ``dtype`` (float32 with TF32 off: the reference; a lower precision:
        the control); ``skip_align``: the planted fault of
        :func:`..reference.nisqa_de_ref.align_hard`."""
        dev = self.ctx.device
        p = {k: v.to(dtype) if v.is_floating_point() else v for k, v in self.state.items()}
        seg, hop = int(self.args["ms_seg_length"]), int(self.args["ms_seg_hop_length"])
        with de_ref.no_tf32(), torch.no_grad():
            fe = ref.FrontEnd(self.args, self.sr, dev, dtype)
            pairs = [(ref.segments(fe.db(self.pcm[j]), seg, hop),
                      ref.segments(fe.db(self.pcm_ref[j]), seg, hop)) for j in files]
            return de_ref.predict(p, self.args, pairs, skip_align).float().cpu().numpy()


def run(ctx):
    sc = PairScoring(ctx)
    sc.engine.warmup(sc.paths, sc.paths_ref)
    sc.call()
    tracer = Tracer(ctx.trace, ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    answers, stats = [], []
    tracer.start()
    t0 = time.perf_counter()
    while True:
        with tracer.span("bench.pass"):
            answers.append(sc.call())
        stats.append(dict(sc.engine.stats["last"]))
        t1 = time.perf_counter()
        if t1 - t0 >= ctx.seconds:
            break
    tracer.stop()
    window = t1 - t0
    passes = len(answers)
    fast = sc.engine.fe_precision == "fast"
    work = {k: v * passes for k, v in sc.tally.of(sc.n_deg, sc.n_ref, fast).items()}
    n = len(sc.paths)

    def check():
        return [("pred_gap", sc.gap(np.concatenate(answers), np.tile(np.arange(n), passes)),
                 ctx.limits["pred_gap"])]

    return Outcome(release=sc.release, e2e={"setup_s": setup_s,
                                            "score_audio_s_per_s": sc.audio_s * passes / window},
                   attempted=passes * n, failed=0, stats=stats, trace=tracer.summary, work=work,
                   window_s=window, precision=ctx.config["precision"], fast=fast,
                   check=check, scoring=sc)
