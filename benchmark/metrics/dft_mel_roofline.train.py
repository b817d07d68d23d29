"""The DFT->mel kernel's share of its roofline in the train steps, in %,
exact mode: the least time the window's train-step front-end work needs
(``counts.work``: each file's own frames, every train file once an epoch)
over the device time of the operations named ``dft_mel`` in the trace."""

from benchmark.counts import peaks


def read(run):
    t = run.trace.device_s("dft_mel") if run.trace is not None else 0.0
    if t <= 0.0:
        return None
    return 100.0 * peaks.kernel_seconds(run.work, "exact") / t
