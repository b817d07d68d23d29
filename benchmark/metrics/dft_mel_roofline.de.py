"""The DFT->mel kernel's share of its roofline over both ends of the pairs,
in %: the least time the window's front-end work needs (``counts.work_de``:
each end's own frames) over the device time of the operations named
``dft_mel`` in the trace."""

from benchmark.counts import peaks


def read(run):
    t = run.trace.device_s("dft_mel") if getattr(run, "trace", None) is not None else 0.0
    if t <= 0.0:
        return None
    return 100.0 * peaks.kernel_seconds(run.work, "fast" if run.fast else "exact") / t
