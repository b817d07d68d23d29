"""Mean decode time of a pass's filler thread, in ms: the engine's own
``stats["last"]["fill_decode_s"]`` (the native fill calls, or the rows
written in Python), over the window's passes that carry it."""


def read(run):
    v = [s["fill_decode_s"] for s in getattr(run, "stats", None) or []
         if s.get("fill_decode_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
