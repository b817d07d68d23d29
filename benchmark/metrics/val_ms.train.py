"""Mean wall time of an epoch's validation pass, in ms: the train engine's
own ``history[..]["val_s"]`` of the window's epochs."""


def read(run):
    v = [h["val_s"] for h in run.history if h.get("val_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
