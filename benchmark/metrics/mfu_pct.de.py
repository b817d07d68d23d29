"""The window's share of the card's peak, in %: the least time its work
takes at the peaks (the model's FLOPs at the configuration's precision, the
DFT->mel step's at the front end's; each end's own segments and frames,
``counts.work_de``) over the window."""

from benchmark.counts import peaks


def read(run):
    w = getattr(run, "work", None)
    if not w or not getattr(run, "window_s", 0):
        return None
    t = (w["model"] / peaks.MODEL_PEAK[run.precision]
         + peaks.kernel_seconds({**w, "bytes": 0}, "fast" if run.fast else "exact"))
    return 100.0 * t / run.window_s
