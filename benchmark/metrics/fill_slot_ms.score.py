"""Mean time a pass's filler thread waited for a free staging slot (and its
last copy), in ms: the engine's own ``stats["last"]["fill_slot_s"]``, over
the window's passes that carry it."""


def read(run):
    v = [s["fill_slot_s"] for s in getattr(run, "stats", None) or []
         if s.get("fill_slot_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
