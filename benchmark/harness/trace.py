"""The traced run's window: one ``torch.profiler`` window a process over
the measured loop (the profiler stops recording the program's ``ctypes``
launches after many windows in one process), read into what the
per-layer metrics need: the device's busy time (the union of its
operations' intervals, so overlapping operations count once) over the
window's host time, the device time by operation name, and the longest
idle gaps, each named by the host span of the benchmark's loop
(``span``; they follow one another, none inside another) that was open
at its middle."""

from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "ptbench.window"


def union(intervals):
    """(the total length covered by ``intervals``, [(start, end), ...]
    the merged intervals in order); each interval counts once where
    several overlap."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def gaps(merged, start, end):
    """The idle intervals of ``[start, end]`` between the merged busy
    intervals ``merged``."""
    out, at = [], start
    for s, e in merged:
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


def span(name):
    """A host span of the benchmark's loop, recorded in a traced run."""
    return torch.profiler.record_function(f"ptbench.{name}")


@contextlib.contextmanager
def window(on):
    """The profiler over the measured loop when ``on``; yields the
    profiler (None when off)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof



def _events(prof):
    """(name, on the device, start ns, end ns) of each event of the
    window, from the profiler's raw records (building its event tree takes
    minutes for a window of autograd's host ops).  A host annotation
    drawn on the device's timeline, such as ``nccl:all_reduce`` around a
    collective's kernel, is not a device operation: it is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        return [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns())
                for e in raw.events()
                if not (e.device_type() == cuda and e.is_user_annotation())]
    return [(e.name, e.device_type == cuda, e.time_range.start * 1000,
             e.time_range.end * 1000) for e in prof.events()
            if not (e.device_type == cuda
                    and getattr(e, "is_user_annotation", False))]


def summary(prof, top=10):
    """The window's numbers from ``prof``: ``window_s`` (the host time of
    the window span), ``busy_s`` (the device's busy time inside it),
    ``ops`` ({device operation name: seconds}), ``device_ops`` and
    ``idle_gaps`` (the ``top`` largest, [name, seconds])."""
    events = _events(prof)
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win[0][2], win[0][3]
    dev, spans, ops = [], [], {}
    for name, on_device, s, t in events:
        if name.startswith("ptbench."):
            if not on_device and name != WINDOW:
                spans.append((s, t, name[len("ptbench."):]))
        elif on_device:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
    busy, merged = union(dev)
    # the loop's spans follow one another: the one open at a gap's middle
    # is the last to start before it, if it has not ended
    spans.sort()
    starts = [x[0] for x in spans]
    idle = {}
    for s, t in gaps(merged, w0, w1):
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid) - 1
        name = (spans[i][2] if i >= 0 and spans[i][1] >= mid
                else "outside the loop's spans")
        idle[name] = idle.get(name, 0.0) + (t - s) * 1e-9
    return dict(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, ops=ops,
        device_ops=sorted(([k, v] for k, v in ops.items()),
                          key=lambda x: -x[1])[:top],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda x: -x[1])[:top])


def kernel_seconds(ops, *names):
    """The device seconds of the operations whose names contain any of
    ``names``."""
    return sum(v for k, v in ops.items() if any(n in k for n in names))
