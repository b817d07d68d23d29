"""The traced run's profile: the window's device activity and what the host
did while the device sat idle.

``Tracer`` wraps ``torch.profiler`` over the measured window. The window's
bounds are two marks (``bench.window_start`` / ``bench.window_end``) put
into the trace by the benchmark, so device and host events are cut to the
same interval. :func:`summarise` reduces the raw events once:

  * busy seconds: the union of the device's activity intervals in the
    window (kernels, copies, sets), and the window's length;
  * device seconds by operation name, and of the operations whose name
    holds a given string (a kernel's time);
  * idle gaps: each stretch of the window with no device activity, named by
    the benchmark span (``bench.*``; "window" when none) open on the host at
    its middle and the outermost operator the host thread was in then
    ("host" when none).
"""

from __future__ import annotations

import bisect

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARKS = ("bench.window_start", "bench.window_end")


def mark(name: str):
    with record_function(name):
        pass


class Tracer:
    """A profiler over the window when tracing, else marks that cost nothing."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.summary = None

    def start(self):
        if not self.on:
            return
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        mark(MARKS[0])

    def stop(self):
        """Ends the window (after the device's queued work) and summarises it."""
        if not self.on or self.prof is None:
            return
        mark(MARKS[1])
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.summary = summarise(self.prof.profiler.kineto_results.events())
        self.prof = None

    def span(self, name: str):
        """A ``bench.*`` span on the host, recorded only when tracing."""
        return record_function(name) if self.on else _Null()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Summary:
    def __init__(self, window_s, busy_s, by_name, gaps):
        self.window_s, self.busy_s, self.by_name, self.gaps = window_s, busy_s, by_name, gaps

    def device_s(self, substring: str) -> float:
        """Device seconds of the operations whose name holds ``substring``."""
        return sum(s for n, s in self.by_name.items() if substring in n)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = {}
        for name, s in self.gaps:
            idle[name] = idle.get(name, 0.0) + s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:96], s] for n, s in ops],
                "idle_gaps": [[n[:96], s] for n, s in gaps]}


def _is_device(e) -> bool:
    """A kernel, copy or set on the device; not the device-side copy the
    profiler makes of a host annotation (``record_function``)."""
    return (e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation()
            and not e.name().startswith("bench."))


def summarise(events, max_named_gaps: int = 200_000) -> Summary:
    marks = {}
    for e in events:
        if e.name() in MARKS:
            marks[e.name()] = e.start_ns()
    if len(marks) != 2:
        raise RuntimeError(f"the trace lacks the window's marks: found {sorted(marks)}")
    w0, w1 = marks[MARKS[0]], marks[MARKS[1]]
    dev, cpu, spans = [], [], []
    main_tid = None
    for e in events:
        if e.name() == MARKS[0]:
            main_tid = e.start_thread_id()
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                dev.append((a, b, e.name()))
        elif e.start_thread_id() == main_tid and e.name() not in MARKS:
            (spans if e.name().startswith("bench.") else cpu).append((s, s + d, e.name()))
    by_name = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    # the union of device intervals, and the gaps between them in the window
    busy, gaps, cur = 0, [], w0
    for a, b, _ in sorted(dev):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return Summary((w1 - w0) / 1e9, busy / 1e9, by_name,
                   _name_gaps(gaps[:max_named_gaps], cpu, spans)
                   + [("other gaps", sum(b - a for a, b in gaps[max_named_gaps:]) / 1e9)])


def _outermost(intervals):
    """Intervals sorted by start -> the ones no other contains."""
    out = []
    for a, b, n in sorted(intervals):
        if out and a < out[-1][1]:
            continue
        out.append((a, b, n))
    return out


def _at(intervals, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return intervals[i][2] if i >= 0 and intervals[i][1] >= t else None


def _name_gaps(gaps, cpu, spans):
    ops = _outermost(cpu)
    op_starts = [a for a, _, _ in ops]
    spans = sorted(spans)  # bench spans follow one another; the latest open one names a gap
    span_starts = [a for a, _, _ in spans]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        span = _at(spans, span_starts, mid) or "window"
        op = _at(ops, op_starts, mid) or "host"
        named.append((f"{span}|{op}", (b - a) / 1e9))
    return named
