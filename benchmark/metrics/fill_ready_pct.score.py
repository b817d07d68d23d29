"""Mean share of a pass's filled batches that the filler had ready before
the main thread reached them, in %: the engine's own ``stats["last"]``
``ready_batches`` over the batches the pass filled (``cold_batches`` on a
partial pass, else ``batches``), over the window's passes that carry it."""


def read(run):
    v = [100.0 * s["ready_batches"] / s.get("cold_batches", s.get("batches"))
         for s in getattr(run, "stats", None) or []
         if s.get("ready_batches") is not None and s.get("cold_batches", s.get("batches"))]
    return sum(v) / len(v) if v else None
