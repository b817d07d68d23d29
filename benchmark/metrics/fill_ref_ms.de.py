"""Mean decode time of a pass's reference ends on the filler thread, in ms:
the engine's own ``stats["last"]["fill_decode_ref_s"]`` (the reference
end's part of ``fill_decode_s``), over the window's passes that carry it."""


def read(run):
    v = [s["fill_decode_ref_s"] for s in getattr(run, "stats", None) or []
         if s.get("fill_decode_ref_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
