"""Median host time a request spent in uploads and launches, in ms: the
engine's own ``stats["last"]["dispatch_s"]`` of each request in the window."""

import numpy as np


def read(run):
    d = run.window["dispatch_s"]
    return 1e3 * float(np.median(d)) if len(d) else None
