"""Training epochs as ``run_train`` runs them: ``NisqaTorch(args).train()``
on the configuration's YAML values over a seeded corpus, each epoch the
train steps (``TrainEngine.run_epoch``), the validation pass, the results
CSV and the checkpoint writes.

Set-up writes the corpus and its CSV, builds the runner, loads weights made
from the seed (a model from scratch), and runs epoch 1, which builds and
warms everything. The window opens when epoch 1's files are written and
closes at the end of the first epoch that ends at or after ``seconds``;
the program is stopped there by raising out of its results writer. The
harness reads epoch ends through a subclass of the program's
``ResultsWriter``, the optimizer through ``register_step_post_hook``, and
the dropout masks of the first steps through a dispatch mode that copies
every Bernoulli draw (or ``native_dropout`` mask) the program makes.

End to end: ``train_audio_s_per_s`` (the train split's audio seconds times
the window's epochs, over the window) and ``setup_s``. Correct: the first
three train steps of epoch 1 against the plain reference (``train_check``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import corpus
from ..counts.work import Tally
from ..reference import train_ref
from ..reference.nisqa_ref import param_spec
from ..trace import Tracer
from ..weights import make_state
from .scoring import Outcome


class WindowClosed(Exception):
    """Raised out of the program's results writer when the window closes."""


class MaskTap(TorchDispatchMode):
    """Copies each dropout mask the program draws while it is entered,
    grouped by the train step that ``step`` names."""

    def __init__(self):
        super().__init__()
        self.step, self.masks = 0, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in ("bernoulli_", "bernoulli"):
            self.masks.setdefault(self.step, []).append(out.detach().clone())
        elif name == "native_dropout":
            self.masks.setdefault(self.step, []).append(out[1].detach().float())
        return out


class Probe:
    """What the harness reads of the running program: the first steps'
    masks, gradients (from Adam's first moment after step 1) and
    parameters (after the last compared step), and the epochs' ends."""

    def __init__(self, ctx, tracer, steps: int):
        self.ctx, self.tracer, self.steps = ctx, tracer, steps
        self.tap, self.tapping = MaskTap(), False
        self.n_steps, self.ends = 0, []
        self.grads, self.params, self.setup_s = None, None, None

    def attach(self, engine):
        self.names = {p: n for n, p in engine.model.named_parameters()}
        self.beta1 = engine.opt.param_groups[0]["betas"][0]
        engine.opt.register_step_post_hook(self.after_step)
        self.tap.__enter__()
        self.tapping = True

    def _untap(self):
        if self.tapping:
            self.tap.__exit__(None, None, None)
            self.tapping = False

    def after_step(self, opt, *_):
        self.n_steps += 1
        self.tap.step = self.n_steps
        if self.n_steps == 1:
            self.grads = {self.names[p]: (opt.state[p]["exp_avg"] / (1.0 - self.beta1)).detach().clone()
                          for g in opt.param_groups for p in g["params"]}
        if self.n_steps == self.steps:
            self.params = {n: p.detach().clone() for p, n in self.names.items()}
            self._untap()

    def epoch_end(self):
        t = time.perf_counter()
        self._untap()
        self.ends.append(t)
        if len(self.ends) == 1:
            self.setup_s = t - self.ctx.t_start
            self.tracer.start()
            self.t0 = time.perf_counter()
        elif t - self.t0 >= self.ctx.seconds:
            self.tracer.stop()
            raise WindowClosed


def write_csv(path: str, names, dbs, mos):
    """The corpus CSV with the YAML's column names: db, filepath_deg, mos."""
    with open(path, "w") as f:
        f.write("db,filepath_deg,mos\n")
        for n, d, m in zip(names, dbs, mos):
            f.write(f"{d},{n},{m:.2f}\n")


def split_dbs(n: int, dbs: list, shares: list) -> list:
    """``n`` db labels in the shares of the source corpus's databases, at
    least one file each (the runner wants every database of the YAML)."""
    counts = np.maximum(1, np.floor(np.array(shares, dtype=float) / sum(shares) * n)).astype(int)
    counts[0] += n - counts.sum()
    return [d for d, c in zip(dbs, counts) for _ in range(c)]


def run(ctx):
    from nisqa_tpu_torch.model import NisqaTorch
    from nisqa_tpu_torch.train import loop

    cfg, c = ctx.config, ctx.config["corpus"]
    y = cfg["yaml"]
    n_train, n_val, sr = int(c["train_files"]), int(c["val_files"]), int(c["sr"])
    data_dir, out_dir = os.path.join(ctx.tmp, "corpus"), os.path.join(ctx.tmp, "runs")
    paths, pcm = corpus.make(data_dir, n_train + n_val, c["seconds_lo"], c["seconds_hi"], c["dist"],
                             sr, ctx.seed, ctx.device)
    mos = np.random.default_rng(corpus.seed_stream(ctx.seed, 6)).uniform(
        c["mos_lo"], c["mos_hi"], n_train + n_val).round(2)
    dbs = (split_dbs(n_train, y["csv_db_train"], c["train_db_shares"])
           + split_dbs(n_val, y["csv_db_val"], c["val_db_shares"]))
    write_csv(os.path.join(data_dir, y["csv_file"]), [os.path.basename(p) for p in paths], dbs, mos)
    os.makedirs(out_dir)
    seed = corpus.seed_stream(ctx.seed, 7) % (2 ** 31)
    args = {**y, "data_dir": data_dir, "output_dir": out_dir, "tr_device": ctx.device, "seed": seed}
    spec = param_spec(y, 1)
    state = make_state(spec, corpus.seed_stream(ctx.seed, 3), ctx.device, cfg["weights"])

    runner = NisqaTorch(args)
    runner.model.load_state_dict(state, strict=True)
    tracer = Tracer(ctx.trace, ctx.device)
    probe = Probe(ctx, tracer, int(ctx.traffic["compare_steps"]))

    class Writer(loop.ResultsWriter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probe.attach(runner.train_engine)

        def save(self, *a, **k):
            super().save(*a, **k)
            probe.epoch_end()

    original = loop.ResultsWriter
    loop.ResultsWriter = Writer
    try:
        runner.train()
    except WindowClosed:
        pass
    finally:
        loop.ResultsWriter = original
        probe._untap()
    if probe.setup_s is None or len(probe.ends) < 2:
        raise RuntimeError(f"training stopped after {len(probe.ends)} epoch(s); the window needs two")

    engine = runner.train_engine
    history = [dict(h) for h in engine.history]
    window = probe.ends[-1] - probe.t0
    epochs = len(probe.ends) - 1
    train_samples = np.array([len(x) for x in pcm[:n_train]])
    val_samples = np.array([len(x) for x in pcm[n_train:]])
    tally = Tally(y, 1, sr)
    tr, va = tally.of(train_samples, fast=False), tally.of(val_samples, fast=True)
    work = {"train_model": tr["model"] * epochs, "dft": tr["dft"] * epochs, "mel": tr["mel"] * epochs,
            "bytes": tr["bytes"] * epochs, "val_model": va["model"] * epochs}
    losses = [term[0][1] for term in history[0]["terms"][: probe.steps]]
    program = {"losses": losses, "grads": probe.grads, "params": probe.params,
               "masks": probe.tap.masks}
    bs = int(y["tr_bs"])

    def release():
        nonlocal runner
        runner = None
        probe.names = None

    inputs = {"state": state, "spec": spec, "pcm": pcm, "mos": mos, "cfg": y, "sr": sr, "bs": bs,
              "order": train_ref.shuffle(seed, 0, n_train), "masks": probe.tap.masks,
              "n_steps": probe.steps, "device": ctx.device}

    def check():
        return train_ref.check(program, state, spec, pcm, mos, y, sr, n_train, bs, seed, probe.steps,
                               ctx.device, ctx.limits)

    return Outcome(release=release, check=check,
                   e2e={"setup_s": probe.setup_s,
                        "train_audio_s_per_s": train_samples.sum() / sr * epochs / window},
                   attempted=probe.steps, failed=0 if probe.params is not None else probe.steps,
                   trace=tracer.summary, history=history[1:], work=work, window_s=window,
                   precision="highest", val_precision=cfg["val_precision"], inputs=inputs,
                   program=program)
