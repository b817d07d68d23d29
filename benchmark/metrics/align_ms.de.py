"""Mean device time of a pass's alignment and fusion, in ms: the engine's
own ``stats["last"]["align_device_s"]`` (CUDA events on the compute stream
around each batch's alignment and fusion, read after the pass's readback),
over the window's passes that carry it."""


def read(run):
    v = [s["align_device_s"] for s in getattr(run, "stats", None) or []
         if s.get("align_device_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
