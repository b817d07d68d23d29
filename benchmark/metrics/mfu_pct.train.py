"""The training window's share of the card's peak, in %: the train steps'
forward, backward and Adam (three times the forward's FLOPs) in float32,
their front end in exact mode, and the validation passes' forward at the
serving precision, each file's own segments and frames (``counts.work``),
at the peaks, over the window."""

from benchmark.counts import peaks


def read(run):
    w = run.work
    t = (3 * w["train_model"] / peaks.MODEL_PEAK[run.precision]
         + peaks.kernel_seconds({**w, "bytes": 0}, "exact")
         + w["val_model"] / peaks.MODEL_PEAK[run.val_precision])
    return 100.0 * t / run.window_s
