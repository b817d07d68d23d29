"""Mean time a pass's main thread waited for the filler after the first
batch, in ms: the engine's own ``stats["last"]`` ``wait_s`` less
``first_wait_s``, over the window's passes that carry both."""


def read(run):
    v = [s["wait_s"] - s["first_wait_s"] for s in getattr(run, "stats", None) or []
         if s.get("wait_s") is not None and s.get("first_wait_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
