"""What the scoring mixes share: the corpus, the weights, the program's
predictor, and the comparison of its answers with the plain reference."""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

from .. import corpus
from ..counts.work import Tally
from ..reference import nisqa_ref as ref
from ..weights import make_state


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on or off, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def finite(v: float) -> float:
    """A number JSON can carry: a gap that is not finite reads as 1e30."""
    return float(v) if math.isfinite(v) else 1e30


def heads_of(cfg: dict) -> int:
    return ref.DIM_HEADS if cfg["model"] == "NISQA_DIM" else 1


class Outcome:
    """A run's result as the harness and the metric readers take it."""

    def __init__(self, release=None, **kw):
        self.trace = None
        self.stats, self.history = [], []
        self._release = release
        self.__dict__.update(kw)

    def release(self):
        """Frees the program's state before the reference runs."""
        if self._release is not None:
            self._release()
            self._release = None


class Scoring:
    """A seeded corpus of ``n_files``, seeded weights written as a
    reference-format ``.tar``, and ``load_predictor`` on it, as a user
    loads a checkpoint, warmed up on the corpus's shapes."""

    def __init__(self, ctx, n_files: int):
        t, cfg = ctx.traffic, ctx.config
        self.ctx, self.cfg, self.args, self.sr = ctx, cfg, cfg["args"], int(t["sr"])
        self.heads = heads_of(cfg)
        self.paths, self.pcm = corpus.make(os.path.join(ctx.tmp, "corpus"), n_files,
                                           t["seconds_lo"], t["seconds_hi"], t["dist"], self.sr,
                                           ctx.seed, ctx.device)
        self.n_samples = np.array([len(x) for x in self.pcm])
        self.audio_s = float(self.n_samples.sum()) / self.sr
        self.state = make_state(ref.param_spec(self.args, self.heads), corpus.seed_stream(ctx.seed, 3),
                                ctx.device, cfg["weights"])
        tar = os.path.join(ctx.tmp, "model.tar")
        torch.save({"args": {**self.args, "model": cfg["model"], "name": cfg["model"]},
                    "model_state_dict": {k: v.cpu() for k, v in self.state.items()},
                    "model_name": cfg["model"]}, tar)
        from nisqa_tpu_torch import load_predictor

        self.predict = load_predictor(tar, batch_size=int(t["batch_size"]), tr_device=ctx.device,
                                      precision=cfg["precision"], cache_mb=float(t["cache_mb"]))
        self.engine = self.predict.engine
        self.tally = Tally(self.args, self.heads, self.sr)

    def release(self):
        self.predict = self.engine = None

    def call(self, paths):
        """One call of the predictor: (files, heads) on the host."""
        return self.predict(paths)

    def reference(self, files, dtype=torch.float32, block: int = 64) -> np.ndarray:
        """The plain reference's (len(files), heads) for corpus files
        ``files``, in ``dtype`` (float32 with TF32 off: the reference; a
        lower precision: the control)."""
        dev = self.ctx.device
        p = {k: v.to(dtype) if v.is_floating_point() else v for k, v in self.state.items()}
        out = []
        with tf32(False), torch.no_grad():
            fe = ref.FrontEnd(self.args, self.sr, dev, dtype)
            seg, hop = int(self.args["ms_seg_length"]), int(self.args["ms_seg_hop_length"])
            for i in range(0, len(files), block):
                segs = [ref.segments(fe.db(self.pcm[j]), seg, hop) for j in files[i:i + block]]
                out.append(ref.predict(p, self.args, segs).float().cpu())
        return torch.cat(out).numpy()

    def gap(self, answers, files, dtype=torch.float32) -> float:
        """The widest gap between ``answers`` (A, heads), the rows of corpus
        files ``files`` (A,), and the reference's rows; a gap that is not
        finite reads 1e30, and so do no answers at all."""
        files = np.asarray(files, dtype=np.int64)
        if not len(files):
            return 1e30
        want = np.unique(files)
        ref_y = self.reference(want.tolist(), dtype)
        rows = ref_y[np.searchsorted(want, files)]
        return finite(float(np.max(np.abs(np.asarray(answers, dtype=np.float64) - rows))))
