"""The padded share of the trunk's segment rows, in %: one minus the rows of
each end's own n_wins (``stats["last"]["own_rows"]``) over the rows the
trunk ran over both ends of every batch row at its bucket
(``trunk_rows``), summed over the window's passes that carry both."""


def read(run):
    v = [(s["own_rows"], s["trunk_rows"]) for s in getattr(run, "stats", None) or []
         if s.get("own_rows") is not None and s.get("trunk_rows")]
    if not v:
        return None
    return 100.0 * (1.0 - sum(o for o, _ in v) / sum(t for _, t in v))
