"""Mean head of a cold pass, in ms: the engine's own
``stats["last"]["head_s"]``, from the call to the first batch's dispatch
(scan, plan and the first fill, when the device has nothing of the pass),
over the window's passes that carry it."""


def read(run):
    v = [s["head_s"] for s in getattr(run, "stats", None) or [] if s.get("head_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
