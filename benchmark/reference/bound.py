"""Bounds: the least time an H100 could take for a kernel's work.

A frozen copy of the port's bound arithmetic and work count: the
benchmark's yardstick for the rooflines, which a program change cannot
move.  The reference tracer (``tracer.py``) carries the same section and
row marks as the port's plain version, so :func:`count_work` over it
counts what the port's count does (``tests/test_benchmark_work.py``).

A bound (:func:`bound`) is the larger of two times.  One is the float32
operations that the work needs over the card's float32 rate.  The other
is the bytes that it must move over the card's memory rate.  The rates
are the H100 SXM data sheet's: 67 TFLOP/s outside the tensor cores, and
3.35 TB/s of HBM3.

:func:`count_work` takes both from a plain version as it runs:

- A dispatch mode counts one operation for each output element of each
  arithmetic, comparison, min/max, clamp, floor, division, square root
  or transcendental op on floating-point data.  It does not count
  selects (``where``), data movement, or integer and boolean ops.
- The plain versions compute every lane of a section and then select.
  The kernel computes only the lanes that take the section.  So the plain
  versions mark their sections with :func:`needed`, and the ops inside a
  section count only for the share of lanes that need them: a live path,
  the lobe it takes, a winner with a map.
- The plain versions mark the table rows they read with :func:`read`.
  Each distinct row counts once, with the columns that the work needs
  of it.

Outside :func:`count_work` the marks do nothing.

K5's bound is K1's for the same scene plus the state the spans must
move (:func:`span_state_bytes`); K6's is its bytes (:func:`scan_bytes`),
and one add per value.  K7's and K8's are K1's for the same scene plus
the work of their gradients (:func:`k7_extra`, :func:`k8_extra`).
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

PEAK_FLOPS = 67e12     # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# the ops counted (aten names): arithmetic, comparisons, min/max, clamp,
# floor, division, square root, transcendentals
COUNTED_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "reciprocal",
    "sin", "cos", "tan", "log", "exp", "pow", "floor", "minimum", "maximum",
    "clamp", "clamp_min", "clamp_max", "lt", "le", "gt", "ge", "eq", "ne",
    "isnan"))
_FLOATS = (torch.float32, torch.float64)

_COUNT = None  # the count in force (inside count_work), or None


@contextlib.contextmanager
def needed(section=None, lanes=None, compacted=False):
    """Marks the ops inside as the work of ``section``, needed only on
    ``lanes``.  ``section`` is a name for the breakdown, and None keeps
    the enclosing one.  ``lanes`` is a bool mask over the ops' lanes, or
    a function that makes one.  A count calls the function with counting
    paused, and outside a count it is never called.  Inside a section over
    the same lanes, the two masks meet.  With ``lanes`` None, the
    enclosing mask holds.  With ``compacted``, the ops run on a compacted
    set of lanes that all need them, and the enclosing mask does not
    apply.  ``lanes`` is then None, or a mask over that set."""
    if _COUNT is None:
        yield
    else:
        with _COUNT.section(section, lanes, compacted):
            yield


def read(table, key, rows, cols):
    """Marks rows ``rows`` of ``table`` as read, with ``cols`` elements
    of each that the work needs.  ``rows`` is an int, a sequence of ints,
    or an int tensor over the lanes of the enclosing section, and only
    the lanes that need the section count.  ``key`` names the table in
    the count's sum, and tables (or slices) of one name add up.  Negative
    rows (no row) do not count."""
    if _COUNT is not None:
        _COUNT.read(table, key, rows, cols)


def tally(name, lanes):
    """Counts the lanes of ``lanes`` (a bool mask, or a function that
    makes one) under ``name``: the paths or bounces that take a section
    whose work another kernel adds (K8's adjoints, :func:`k8_extra`).
    Outside a count it does nothing and ``lanes`` is never called."""
    if _COUNT is not None:
        _COUNT.tally(name, lanes)


def bound(ops, n_bytes):
    """(bound in ms, "operations" or "bytes"): the larger of the two
    times, and the term that gives it."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def span_state_bytes(n_keys, counts, spans, pix=False):
    """The state bytes K5's spans of one sample must move besides K1's
    work, 4 per plane value.  ``counts`` are the sample's live counts
    entering each bounce; ``spans`` its spans as (d0, d1, rays run).  The
    ``counts[d0]`` paths live entering a later span read every plane
    (``n_keys`` of them), and the other rays it runs read ``live`` alone.
    A span that is not the last writes every plane of the ``counts[d1]``
    paths live at its end, and the radiance and ``live`` (4 planes) of
    those that ended in it; the last writes only the radiance of the paths
    that entered it.  With ``pix`` (the sorted engine) the last plane is
    the pixel id, written once, at raygen.  The engines' own torch ops
    (the sorted engine's gather, the split engine's sums) are not K5's
    work."""
    depth = len(counts)
    n = 0
    for d0, d1, n_run in spans:
        live_in = counts[d0]
        if d0 > 0:
            n += n_keys * live_in + (n_run - live_in)
        elif pix:
            n += n_run
        if d1 == depth:
            n += 3 * live_in
        else:
            n += (n_keys - pix) * counts[d1] + 4 * (live_in - counts[d1])
    return 4 * n


def scan_bytes(n):
    """The bytes any exclusive scan of ``n`` int32 values must move:
    each value read once and its prefix written once (no design's own
    traffic, such as K6's status words)."""
    return 8 * n


# The least float ops of K8's adjoints (``csrc/megakernel.cu``), counted
# from their code (each arithmetic op and each atomic add one op; selects,
# comparisons and the recomputed nearest hit not counted): ``hit_adj`` of a
# cube, the cheapest winner (a sphere's is 333, a triangle's, ``tri_adj``
# with the recomputed hit it needs, 341), plus the specular lobe's part of
# ``bounce_adj``, the cheaper lobe; and raygen's adjoint, once a path.
# NEE's adjoint (``nee_adj``) is counted as nothing: the count of the
# lights a hit sees is not kept.
K8_SCATTER_ADJ_OPS = 251 + 74
K8_RAYGEN_ADJ_OPS = 106
# The sections' adjoints beside those, on the lanes that take them (the
# plain version's tallies, :func:`tally`), counted the same way but for
# the forward values they compute again (a least implementation would
# keep them): the thin lens a path (aperture > 0), the moving winner's
# origin and point a scattering hit, the tilted normal a bumped scatter
# (``bump_adj``), the power-cosine lobe an imperfect specular bounce
# (``spec_lobe_adj``), a refraction's tint, Snell's direction and push
# beyond the specular lobe that K8_SCATTER_ADJ_OPS counts (77 - 74), and an
# inside scatter of SSS, which takes no hit's or lobe's adjoint (22 - 325).
K8_SECTION_ADJ_OPS = {"dof": 77, "motion": 15, "bump": 154, "imperfect": 112,
                      "refraction": 77 - 74, "sss scatter": 22 - 325}
# K8 keeps the state entering each bounce (``Saved``: 9 floats and 2
# flags, 40 bytes), written once and read once; the mesh builds also the
# bounce's winner (geom and triangle row, 8 bytes), the SSS builds the
# medium (4 floats, 16 bytes).
K8_SAVED_BYTES = 40
K8_WINNER_BYTES = 8
K8_MEDIUM_BYTES = 16
# K7's fold, the least of it: w = ct * rad (3 products) and its sum (2
# adds) a path, and for each scatter a division and an add a color
# channel (``grad_fold``).
K7_PATH_OPS = 5
K7_SCATTER_OPS = 6


def scatters(counts):
    """The least number of bounces of one sample that hit a geom and
    scatter: each path live entering bounce d > 0 scattered at bounce
    d - 1 (an emissive hit or a miss ends it)."""
    return int(sum(counts[1:]))


def k7_extra(counts, n_pix, n_mats):
    """(ops, bytes) K7 needs for one sample beside K1's work: the fold
    (``K7_PATH_OPS`` a path, ``K7_SCATTER_OPS`` a scatter), the cotangent
    read (12 bytes a pixel) and the material table read and the gradient
    table written (8 floats a material each)."""
    ops = K7_PATH_OPS * n_pix + K7_SCATTER_OPS * scatters(counts)
    return ops, 12 * n_pix + 2 * 32 * n_mats


def k8_extra(counts, n_pix, n_tab, nee, mesh=False, sss=False,
             tallies=None):
    """(ops, bytes) K8 needs for one sample beside K1's work, and the
    gradient table written (``n_tab`` floats) and the cotangent read (12
    bytes a pixel).  With NEE: the adjoints (``K8_SCATTER_ADJ_OPS`` a
    scatter, ``K8_RAYGEN_ADJ_OPS`` a path, and ``K8_SECTION_ADJ_OPS`` on
    the lanes of each section in ``tallies``, the plain version's
    :func:`tally` of the same sample) and the state of each live bounce
    written and read once (``K8_SAVED_BYTES`` each way, and with ``mesh``
    its winner, ``K8_WINNER_BYTES``, with ``sss`` its medium,
    ``K8_MEDIUM_BYTES``).  Without NEE, the materials' gradient is the
    only one that is not zero (at fixed draws the path is piecewise
    constant in the camera, the transforms, the lens, the exponent, the
    ior, the bump and the medium's sigma), and it is K7's fold of each
    path's factors, which needs no stored state: K7's ops (``K7_PATH_OPS``
    a path, ``K7_SCATTER_OPS`` a scatter)."""
    n_bytes = 12 * n_pix + 4 * n_tab
    if not nee:
        return (K7_PATH_OPS * n_pix + K7_SCATTER_OPS * scatters(counts),
                n_bytes)
    ops = (K8_SCATTER_ADJ_OPS * scatters(counts)
           + K8_RAYGEN_ADJ_OPS * n_pix)
    for name, n in (tallies or {}).items():
        ops += K8_SECTION_ADJ_OPS[name] * n
    saved = (K8_SAVED_BYTES + (K8_WINNER_BYTES if mesh else 0)
             + (K8_MEDIUM_BYTES if sss else 0))
    return ops, n_bytes + 2 * saved * int(sum(counts))


def count_work(fn, tallies=None):
    """Runs ``fn`` (a plain version) under a count.  Returns (``fn``'s
    result, the ops by section, the bytes read by table): each a dict.
    ``tallies``, a dict, gets the lanes counted by :func:`tally`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    global _COUNT

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()
            # (key, table) -> (rows read: bool tensor, bytes a row)
            self.rows = {}
            self.stack = [("other", None, 1.0)]  # (section, mask, share)
            self.paused = False
            self.tallies = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (not self.paused and isinstance(out, torch.Tensor)
                    and func.overloadpacket.__name__ in COUNTED_OPS
                    and (out.dtype in _FLOATS or any(
                        isinstance(a, torch.Tensor) and a.dtype in _FLOATS
                        for a in args))):
                name, _, share = self.stack[-1]
                self.ops[name] += out.numel() * share
            return out

        @contextlib.contextmanager
        def section(self, name, lanes, compacted):
            outer_name, outer, outer_share = self.stack[-1]
            mask, share = (None, 1.0) if compacted else (outer, outer_share)
            if lanes is not None:
                self.paused = True
                try:
                    mask = lanes() if callable(lanes) else lanes
                    if outer is not None and not compacted:
                        if outer.shape != mask.shape:
                            raise ValueError(
                                f"section {name}: lanes {tuple(mask.shape)}"
                                f" inside lanes {tuple(outer.shape)}")
                        mask = mask & outer
                    share = float(mask.sum()) / max(mask.numel(), 1)
                finally:
                    self.paused = False
            self.stack.append((name or outer_name, mask, share))
            try:
                yield
            finally:
                self.stack.pop()

        def tally(self, name, lanes):
            self.paused = True
            try:
                mask = lanes() if callable(lanes) else lanes
                self.tallies[name] += int(mask.sum())
            finally:
                self.paused = False

        def read(self, table, key, rows, cols):
            self.paused = True
            try:
                rows = torch.as_tensor(rows, dtype=torch.int64,
                                       device=table.device).reshape(-1)
                mask = self.stack[-1][1]
                if mask is not None:
                    if mask.shape != rows.shape:
                        raise ValueError(
                            f"read of {key}: rows {tuple(rows.shape)} in "
                            f"lanes {tuple(mask.shape)}")
                    rows = rows[mask]
                at = (key, table.data_ptr())
                if at not in self.rows:
                    self.rows[at] = (
                        torch.zeros(table.shape[0], dtype=torch.bool,
                                    device=table.device),
                        cols * table.element_size())
                self.rows[at][0][rows[rows >= 0]] = True
            finally:
                self.paused = False

    count = Count()
    outer, _COUNT = _COUNT, count
    try:
        with count:
            out = fn()
    finally:
        _COUNT = outer
    if tallies is not None:
        tallies.update(count.tallies)
    n_bytes = Counter()
    for (key, _), (seen, row_bytes) in count.rows.items():
        n_bytes[key] += int(seen.sum()) * row_bytes
    return out, dict(count.ops), dict(n_bytes)
