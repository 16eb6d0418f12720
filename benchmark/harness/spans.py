"""The program's own host spans (``pathtrace_tpu_torch/utils/profiling.
span``), as this process recorded them in its traced window, for the
per-layer metrics that read them: the program records a span only while a
profiler runs, and the window is this process's one profiler window."""

from __future__ import annotations


def mean_s(name):
    """The mean seconds of the program's spans named ``name``; None where
    the program records no spans or none of that name ran."""
    try:
        from pathtrace_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    d = [s.end_ns - s.start_ns for s in spans()
         if s.name == name and s.end_ns]
    return sum(d) * 1e-9 / len(d) if d else None
