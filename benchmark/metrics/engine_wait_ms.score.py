"""Mean time a pass's main thread waited for the filler thread's decode,
in ms: the engine's own ``stats["last"]["wait_s"]`` over the window's passes."""


def read(run):
    waits = [s["wait_s"] for s in run.stats if s.get("wait_s") is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None
