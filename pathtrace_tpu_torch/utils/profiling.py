"""Profiling and timing helpers.

Counterpart of ``pathtrace_tpu/utils/profiling.py``:

* :func:`trace` records a ``torch.profiler`` trace (the card's kernels
  too when CUDA is there) and writes it for Perfetto / TensorBoard;
  :func:`device_busy` reads the card's busy time out of it;
* :func:`time_fn` times a call: on the card the median of CUDA events
  around it, the result read back to the host; on the CPU
  ``time.perf_counter``;
* :func:`bounce_stats` prints the live paths of each bounce.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir=None, device="cuda"):
    """``with profiling.trace() as prof: render(...)``: a
    ``torch.profiler`` window over the block, with CUDA activity when
    ``device`` is a CUDA device; on exit the trace is written to
    ``logdir`` (default: ``pathtrace_tpu_torch_trace`` in the temporary
    directory) as ``trace.json``.  Yields the profiler, whose
    ``key_averages()`` and :func:`device_busy` read the window."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "pathtrace_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
