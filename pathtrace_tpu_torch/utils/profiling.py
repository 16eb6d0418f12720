"""Profiling and timing helpers.

Counterpart of ``pathtrace_tpu/utils/profiling.py``:

* :func:`trace` records a ``torch.profiler`` trace (the card's kernels
  too when CUDA is there) and writes it for Perfetto / TensorBoard;
  :func:`device_busy` reads the card's busy time out of it;
* :func:`span` marks a stretch of the program's host work while a
  profiler records (``ptt.<name>`` in the trace, a record in
  :func:`spans`) and costs one flag check when none does;
* :func:`counter` gives the first call of a profiler's window a device
  tensor to count its events into (None to every other call), and
  :func:`counters` reads them after the window;
* :func:`time_fn` times a call: on the card the median of CUDA events
  around it, the result read back to the host; on the CPU
  ``time.perf_counter``;
* :func:`bounce_stats` prints the live paths of each bounce.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from torch._C._autograd import _profiler_enabled


@contextlib.contextmanager
def trace(logdir=None, device="cuda"):
    """``with profiling.trace() as prof: render(...)``: a
    ``torch.profiler`` window over the block, with CUDA activity when
    ``device`` is a CUDA device; on exit the trace is written to
    ``logdir`` (default: ``pathtrace_tpu_torch_trace`` in the temporary
    directory) as ``trace.json``.  Yields the profiler, whose
    ``key_averages()`` and :func:`device_busy` read the window.  The
    program's spans (:func:`span`) of the window are in ``trace.json``,
    as ``ptt.<name>``, and in :func:`spans`, which this clears when it
    starts, as it clears :func:`counters`."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "pathtrace_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _RECORDS.clear()
    _OPEN.clear()
    _COUNTERS.clear()
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass
class SpanRecord:
    """One :func:`span`: its ``name``, the index in :func:`spans` of the
    span that was open around it (-1: none), ``it`` (the iteration that
    the spans of one chunk or step share, or None) and its start and end
    on the wall clock (``time.time_ns()``, the clock of the profiler's
    raw events)."""
    name: str
    parent: int
    it: int | None
    start_ns: int
    end_ns: int = 0


_RECORDS = []  # the SpanRecords, while a profiler records
_OPEN = []     # the indices of the spans open now, innermost last


class span:
    """``with profiling.span("name", it):`` marks the block.  While a
    ``torch.profiler`` records, the block is ``record_function(
    "ptt.name")`` in its trace and a :class:`SpanRecord` in :func:`spans`;
    otherwise it is a flag check and nothing else, so the program's hot
    paths keep their spans when no one traces them."""

    __slots__ = ("name", "it", "_fn", "_rec")

    def __init__(self, name, it=None):
        self.name, self.it, self._rec = name, it, None

    def __enter__(self):
        if _profiler_enabled():
            self._fn = torch.profiler.record_function(f"ptt.{self.name}")
            self._fn.__enter__()
            self._rec = SpanRecord(self.name, _OPEN[-1] if _OPEN else -1,
                             self.it, time.time_ns())
            _OPEN.append(len(_RECORDS))
            _RECORDS.append(self._rec)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.end_ns = time.time_ns()
            if _OPEN:
                _OPEN.pop()
            self._fn.__exit__(*exc)
        return False


def spans():
    """The :class:`SpanRecord` records of the spans that ran while a profiler
    recorded, in the order they opened; :func:`trace` clears them when it
    starts."""
    return list(_RECORDS)


_COUNTERS = {}  # name -> its int64 tensor, asked for in the profiler's window
# a counter was asked for while no profiler recorded: the next ask under a
# profiler starts a new window's counters
_OFF_SINCE = [True]


def counter(name, shape, device):
    """The counter ``name`` for one call of a profiler's window: the
    first call that asks for it while a ``torch.profiler`` records gets an
    int64 tensor of ``shape`` on ``device``, zeroed, and adds its events
    into it (a kernel on the card, with no copy and no wait); every other
    call gets None and counts nothing: the window's later calls, and every
    call while no profiler records.  So the window's other calls run as
    they run untraced, and a trace of the window times them.
    :func:`counters` reads the counters.  They start afresh when
    :func:`trace` starts, and at the first ask under a profiler after an
    ask under none (two windows with no ask between them count as one)."""
    if not _profiler_enabled():
        _OFF_SINCE[0] = True
        return None
    if _OFF_SINCE[0]:
        _COUNTERS.clear()
        _OFF_SINCE[0] = False
    if name in _COUNTERS:
        return None
    t = _COUNTERS[name] = torch.zeros(tuple(shape), dtype=torch.int64,
                                      device=device)
    return t


def counters():
    """{name: its counts on the host, an int64 numpy array} of every
    counter of the window (:func:`counter`); the copy waits for the work
    that adds into it."""
    return {name: t.cpu().numpy().copy() for name, t in _COUNTERS.items()}


def device_busy(prof):
    """(the card's busy µs, the µs from its first kernel's start to its
    last one's end) in the window of ``prof``: the union of the device
    kernels' intervals, so that kernels that overlap count once."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, (spans[-1][1] - spans[0][0]) if spans else 0.0


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def time_fn(fn, *args, iters: int = 20, warmup: int = 2, **kwargs):
    """The median seconds of one call of ``fn(*args, **kwargs)`` and its
    last output.  When the output's first tensor is on the card: CUDA
    events around each call and a read of its sum on the host, which
    waits for the work (a call returns before the card is done);
    otherwise ``time.perf_counter`` around each call."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
        float(_first(out).sum())
    cuda = _first(out).device.type == "cuda"
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            float(_first(out).sum())
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            float(_first(out).sum())
            times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def bounce_stats(live_counts) -> str:
    """The live paths entering each bounce, as a table (README.md:284-293
    of the reference's course): counts (depth,) or (samples, depth),
    averaged over the samples."""
    c = np.asarray(live_counts.cpu() if torch.is_tensor(live_counts)
                   else live_counts)
    if c.ndim > 1:
        c = c.reshape(-1, c.shape[-1]).mean(axis=0)
    lines = ["bounce  live_rays  frac_of_camera_rays"]
    for d, n in enumerate(c):
        lines.append(f"{d:6d}  {int(n):9d}  {n / max(c[0], 1):.3f}")
    return "\n".join(lines)
