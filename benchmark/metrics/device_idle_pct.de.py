"""The device's idle share of the traced window, in %: one minus the union
of its activity intervals over the window's length."""


def read(run):
    trace = getattr(run, "trace", None)
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
