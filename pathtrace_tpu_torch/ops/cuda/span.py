"""The split and sorted engines on the span kernel K5 (and the scan K6).

Counterpart of the reference's span section of
``pathtrace_tpu/ops/pallas/megakernel.py`` (``_state_keys``,
``_run_span``, ``pathtrace_batch_split``, ``pathtrace_batch_sorted``).
A span runs bounces [d0, d1) of one sample on path state kept in
(keys, N) float32 planes between spans (the rows named by
``megakernel.state_keys``; ``live`` and ``emit_ok`` hold 1 or 0):

* :func:`trace_span` -- K5 (``csrc/megakernel.cu`` ``k5_span``, in the
  K1 library of the scene's feature mask) on a CUDA device, or its plain
  version (``megakernel.init_state``/``megakernel.bounces`` on the
  lanes K5 would run) on the CPU;
* the **split engine** (:func:`pathtrace_batch_split`): bounces
  [0, split) on every pixel; the paths that ended add their radiance
  now; the live-tile table (tiles of ``TILE`` = 128 rays, K5's block) is
  the stable live-first partition of the tiles (``ops/scan.py``
  ``compact_indices``, on K6), and the resumed span [split, depth) runs
  one block per table entry while the entry is below the live-tile count,
  which stays on the card; its radiance is added on the live tiles;
* the **sorted engine** (:func:`pathtrace_batch_sorted`): one span per
  bounce; before each later bounce the rays are re-sorted by
  :func:`sort_perm` (dead last, then a Morton code of the origin's 5-bit
  cell, then the direction's octant) and gathered by :func:`permute`; the
  pixel id rides along (an int32 plane, so exact for any image) and
  keys the random draws, so the order never changes a ray's result; the
  dead sort last, so each later span runs only the tiles below the live
  count that the span before it left on the card; at the end the
  radiance is scattered back to its pixel.

A ray that enters a span dead reads ``live`` alone and writes nothing: its
planes already hold what the engines read of it.

Both give K1's image and live counts bit for bit: every draw is keyed on
(iteration, pixel, bounce, draw), and each sample's radiance is added to
its pixel once (the other term is +0.0).  The engine code is the same
torch code on both devices; only the span and the scan run a kernel or
a plain version.  No value goes back to the host in the sample loop.
The reference's reroutes to other engines (``_xla_fallback``, the
``MESH_STREAM_BYTES`` and ``KTEX_MAX_TEXELS`` limits, streamed spans) are
TPU-only: every scene runs on K5 here.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch

from .. import scan
from . import megakernel as K

# Launches of K5 (``trace_span`` on a CUDA device) by feature mask.
LAUNCHES = Counter()
TILE = 128  # rays per tile of the split engine: K5's block (kBlock)
RAD_KEYS = slice(9, 12)  # rr, rg, rb in every state_keys
LIVE_KEY = 12

# A list to record (phase, start, stop) CUDA events around the engines'
# steps (span, scan, sort_perm, permute, unpermute) in, or None (off).
EVENTS = None


@contextlib.contextmanager
def _phase(name, device):
    if EVENTS is None or device.type != "cuda":
        yield
        return
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    yield
    stop.record()
    EVENTS.append((name, start, stop))


def span_plain(job, state, keys, d0, d1, it, counts, tbl=None, n_live=None,
               live_out=None):
    """K5's plain version: the same lanes, the same result.  The rays of
    the tiles ``tbl[:n_live]`` (without a table: the tiles that start
    below ``n_live``, or all) run ``megakernel.init_state`` (d0 = 0) or,
    entering live, load their planes, then ``megakernel.bounces``; a ray
    that enters dead reads ``live`` alone and keeps every plane.  A span
    that is not the last writes every plane of the paths still live and
    the radiance and ``live`` of those that ended; the last writes the
    radiance.  ``live_out`` gets the paths live at the span's end added."""
    device = state.device
    n = state.shape[1]
    sc = K.plain_scene(**job)
    if tbl is not None:
        tiles = tbl[:int(n_live)].long()
        slots = (tiles[:, None] * TILE
                 + torch.arange(TILE, device=device)).reshape(-1)
        slots = slots[slots < n]
    else:
        n_run = n if n_live is None else min(n, -(-int(n_live) // TILE) * TILE)
        slots = torch.arange(n_run, device=device)
    if d0 > 0:
        slots = slots[state[LIVE_KEY, slots] != 0.0]
    carry = keys[-1] == "pix"
    pix_plane = state[-1].view(torch.int32) if carry else None
    pix = slots if d0 == 0 or not carry else pix_plane[slots].long()
    if d0 == 0:
        st = K.init_state(sc, it, pix, job["width"], job["height"])
    else:
        st = {k: state[i, slots] for i, k in enumerate(keys) if k != "pix"}
        st["live"] = st["live"].to(torch.bool)
        if "emit_ok" in st:
            st["emit_ok"] = st["emit_ok"].to(torch.bool)
    st = K.bounces(sc, st, it, pix, d0, d1, counts)
    live = st["live"]
    if live_out is not None:
        live_out += live.sum().to(live_out.dtype)
    if d1 == job["depth"]:
        write = [(i, k, slice(None)) for i, k in enumerate(keys)
                 if k in ("rr", "rg", "rb")]
    else:
        write = [(i, k, live if k not in ("rr", "rg", "rb", "live") else
                  slice(None)) for i, k in enumerate(keys) if k != "pix"]
    for i, k, on in write:
        state[i, slots[on]] = st[k][on].to(torch.float32)
    if d0 == 0 and carry:
        pix_plane[slots] = slots.to(torch.int32)


def _int32_one(name, t, device):
    if t is not None and (t.device != device or t.dtype != torch.int32 or
                          t.numel() != 1):
        raise ValueError(f"{name}: want one int32 value on {device}")


def trace_span(job, state, keys, d0, d1, it, counts, tbl=None, n_live=None,
               live_out=None):
    """Bounces [d0, d1) of iteration ``it`` on the state planes ``state``
    ((len(keys), W*H) float32, rows ``keys``: ``megakernel.state_keys`` of
    the job, with ``"pix"`` last for the sorted engine), in place; d0 = 0
    runs raygen.  ``job`` is ``megakernel.prepare``'s.  Adds the live
    count entering each bounce into ``counts`` ((depth,) int64).  With
    ``tbl`` (int32 tile ids, one per tile of ``TILE`` rays) and ``n_live``
    (an int32 tensor of one value), only the tiles ``tbl[:n_live]`` run;
    with ``n_live`` alone (a later span of the sorted engine, whose live
    rays come first), only the tiles that start below ``n_live``.  A ray
    that enters dead reads ``live`` alone and writes nothing; a span that
    is not the last writes every plane of the paths still live and the
    radiance and ``live`` of those that ended in it, the last only the
    radiance.  ``live_out`` (an int32 tensor of one value) gets the paths
    live at the span's end added.

    On a CUDA device this launches K5 of the job's feature mask on the
    current stream and raises if the build or the launch fails; on the
    CPU it is :func:`span_plain`.  Raises ``ValueError`` for a plain-only
    job (``megakernel.Job.check_kernel``), on the CPU too."""
    job.check_kernel("K5")
    device = state.device
    if device.type == "cpu":
        return span_plain(job, state, keys, d0, d1, it, counts, tbl,
                          n_live, live_out)
    if device.type != "cuda":
        raise ValueError(f"K5 runs on cuda or cpu tensors, not {device}")
    from . import build

    width, height, depth = job["width"], job["height"], job["depth"]
    n_rays = width * height
    carry = keys[-1] == "pix"
    want = K.state_keys(job["features"], job["lights"] is not None, carry)
    if tuple(keys) != want:
        raise ValueError(f"state keys {keys}, want {want}")
    if state.device != job["cam"].device or \
            state.dtype != torch.float32 or \
            tuple(state.shape) != (len(keys), n_rays) or \
            not state.is_contiguous():
        raise ValueError(
            f"state: want a contiguous float32 ({len(keys)}, {n_rays}) "
            f"tensor on {job['cam'].device}, got {state.dtype} "
            f"{tuple(state.shape)} on {state.device}")
    if counts.device != device or counts.dtype != torch.int64 or \
            tuple(counts.shape) != (depth,):
        raise ValueError(f"counts: want ({depth},) int64 on {device}")
    if not (0 <= d0 < d1 <= depth and n_rays < 2 ** 31):
        raise ValueError(f"bad span [{d0}, {d1}) of depth {depth}, "
                         f"{n_rays} rays")
    n_tiles = -(-n_rays // TILE)
    if tbl is not None and (
            carry or n_live is None or tbl.device != device or
            tbl.dtype != torch.int32 or tuple(tbl.shape) != (n_tiles,) or
            not tbl.is_contiguous()):
        raise ValueError(
            f"tile table: want ({n_tiles},) int32 tile ids and an int32 "
            f"live count on {device}, for the split engine's state")
    if tbl is None and n_live is not None and d0 == 0:
        raise ValueError("a live count without a tile table is a later "
                         "span's: raygen runs every ray")
    _int32_one("n_live", n_live, device)
    _int32_one("live_out", live_out, device)
    lib = build.load_k1(job.mask)
    n_keys = lib.pt_k5_state_keys()
    with torch.cuda.device(device), _phase("span", device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_k5_span(
            *job.args, width, height, state.data_ptr(), len(keys),
            n_keys if carry else -1, n_rays, K.ptr(tbl), K.ptr(n_live),
            n_tiles, K.ptr(live_out), d0, d1, depth, it & 0xFFFFFFFF,
            counts.data_ptr(), stream)
    K.launch_error("K5", lib, err)
    LAUNCHES[job.mask] += 1


def split_batch(job, it0, n_iters, split, plain=False):
    """``n_iters`` samples of the split engine from iteration ``it0`` on
    ``job`` (``megakernel.prepare``'s), split at bounce ``split`` (0 <
    split < depth): (radiance (P,3) f32 summed over the samples, counts
    (depth,) int64).  With ``plain``, the span and the scan are their
    plain versions on any device."""
    span = span_plain if plain else trace_span
    width, height, depth = job["width"], job["height"], job["depth"]
    device = job["cam"].device
    n_pix = width * height
    n_tiles = -(-n_pix // TILE)
    keys = K.state_keys(job["features"], job["lights"] is not None)
    state = torch.empty((len(keys), n_pix), device=device)
    acc = torch.zeros((n_pix, 3), device=device)
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    rad = state[RAD_KEYS]
    for s in range(n_iters):
        it = (it0 + s) & 0xFFFFFFFF
        span(job, state, keys, 0, split, it, counts)
        live = state[LIVE_KEY] != 0.0
        # the paths that ended: their radiance is final, added now and
        # zeroed (x + 0.0 == x for the non-negative radiance)
        acc += torch.where(live, 0.0, rad).T
        rad.copy_(torch.where(live, rad, 0.0))
        # the live-first tile table, its count left on the card
        tlive = torch.nn.functional.pad(
            live, (0, n_tiles * TILE - n_pix)).view(n_tiles, TILE).any(1)
        with _phase("scan", device):
            tbl, n_live = scan.compact_indices(tlive, plain)
        span(job, state, keys, split, depth, it, counts, tbl, n_live)
        # the resumed span wrote only the live tiles
        on = tlive.repeat_interleave(TILE)[:n_pix]
        acc += torch.where(on, rad, 0.0).T
    return acc, counts


def clamp_split(split, depth):
    """The reference's split bounce: ``split`` held to [1, depth - 1], or
    0 (no split: K1's path) at depth 1."""
    return max(1, min(int(split), depth - 1)) if depth > 1 else 0


def pathtrace_batch_split(scene, it0, n_iters, split=3, device="cuda",
                          nee=False, rr=False):
    """``n_iters`` samples per pixel on the split engine (the reference's
    ``pathtrace_batch_split``): bounces [0, split) on every pixel, then
    [split, depth) on the live tiles.  ``split`` is held to [1, depth-1]
    as the reference's; with depth 1 the render goes to K1
    (``megakernel.pathtrace_batch_cuda``).  Returns (accumulated radiance
    (P,3) f32, counts (depth,) int64) on ``device``, bit-equal to K1's.
    A CPU device runs the plain versions; a CUDA device the kernels, and
    raises when there is no GPU."""
    job = K.prepare(scene, device, nee=nee, rr=rr)
    return engine(scene, job, split=split)[1](it0, n_iters)


def sort_box(scene, device):
    """The box the sort key quantizes origins in: (lo, span), each (3, 1)
    float32 on ``device``: the geoms' ``translation - |scale|`` minimum,
    and the extent to the ``translation + |scale|`` maximum, at least
    1e-3 (the reference's; a mesh vertex past its geom's scale only
    saturates the cell)."""
    t = np.asarray(scene.geoms.translation, np.float32)
    s = np.abs(np.asarray(scene.geoms.scale, np.float32))
    lo = np.min(t - s, axis=0)
    span = np.maximum(np.max(t + s, axis=0) - lo, np.float32(1e-3))
    return tuple(torch.as_tensor(v.astype(np.float32)).reshape(3, 1)
                 .to(device) for v in (lo, span))


# device -> (each 5-bit cell index with its bit b moved to bit 3b, one axis
# of a Morton code; the (3, 1) weights 4, 2, 1 of x, y, z), made once
_KEY_TABLES = {}


def _key_tables(device):
    if device not in _KEY_TABLES:
        spread = [sum(((v >> b) & 1) << (3 * b) for b in range(5))
                  for v in range(32)]
        _KEY_TABLES[device] = (torch.tensor(spread, device=device),
                               torch.tensor([[4], [2], [1]], device=device))
    return _KEY_TABLES[device]


def sort_perm(state, lo, span):
    """The order the sorted engine traces the next bounce in (the
    reference's ``sort_perm``, bit for bit): a key of the origin's 5-bit
    cell in the box (``sort_box``) per axis, Morton-interleaved (x at bit
    3b+2, y at 3b+1, z at 3b of the cell's bit b), then the direction's
    octant (x, y, z signs); a dead ray's key 1 << 29, so the dead sort
    last; a stable argsort.  The bits of the key do not overlap, so they
    are summed: a few whole-plane ops a sort.  A NaN cell is cell 0, as
    the reference's int32 cast makes it (torch's int cast of NaN is
    -2^63, no index).  Returns int64 (N,)."""
    spread, weight = _key_tables(state.device)
    q = torch.clamp((state[0:3] - lo) / span * 31.0, 0.0, 31.0).nan_to_num(
        0.0).to(torch.int64)
    key = (spread[q] * weight).sum(0) * 8 \
        + ((state[3:6] > 0) * weight).sum(0)
    key = torch.where(state[LIVE_KEY] != 0.0, key, 1 << 29)
    return torch.argsort(key, stable=True)


def permute(state, perm):
    """The state's rays in the order ``perm``: one gather of every plane
    (the int32 bits, so the pixel ids move exactly)."""
    return state.view(torch.int32).index_select(1, perm).view(torch.float32)


def sorted_batch(job, it0, n_iters, lo, span, plain=False):
    """``n_iters`` samples of the sorted engine from iteration ``it0`` on
    ``job`` (``megakernel.prepare``'s), keys quantized in the box
    (``lo``, ``span``) of :func:`sort_box`: (radiance (P,3) f32 summed
    over the samples, counts (depth,) int64).  With ``plain``, the spans
    are their plain version on any device."""
    trace = span_plain if plain else trace_span
    width, height, depth = job["width"], job["height"], job["depth"]
    device = job["cam"].device
    n_pix = width * height
    keys = K.state_keys(job["features"], job["lights"] is not None, True)
    acc = torch.zeros((n_pix, 3), device=device)
    rad = torch.empty((n_pix, 3), device=device)
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    # each sample's paths live entering each bounce, left on the card by
    # the span before it: after the sort they are the first slots
    live = torch.zeros((n_iters, depth + 1), dtype=torch.int32,
                       device=device)
    for s in range(n_iters):
        it = (it0 + s) & 0xFFFFFFFF
        state = torch.empty((len(keys), n_pix), device=device)
        trace(job, state, keys, 0, 1, it, counts, live_out=live[s, 1:2])
        for d in range(1, depth):
            with _phase("sort_perm", device):
                perm = sort_perm(state, lo, span)
            with _phase("permute", device):
                state = permute(state, perm)
            trace(job, state, keys, d, d + 1, it, counts,
                  n_live=live[s, d:d + 1], live_out=live[s, d + 1:d + 2])
        # every pixel id once: scatter the radiance back to its pixel
        with _phase("unpermute", device):
            pix = state[-1].view(torch.int32).long()
            rad.index_copy_(0, pix, state[RAD_KEYS].T)
        acc += rad
    return acc, counts


def pathtrace_batch_sorted(scene, it0, n_iters, device="cuda", nee=False,
                           rr=False):
    """``n_iters`` samples per pixel on the sorted engine (the
    reference's ``pathtrace_batch_sorted``): one span per bounce, the rays
    re-sorted before each later bounce.  Returns (accumulated radiance
    (P,3) f32, counts (depth,) int64) on ``device``, bit-equal to K1's.
    A CPU device runs the plain versions; a CUDA device the kernel, and
    raises when there is no GPU."""
    job = K.prepare(scene, device, nee=nee, rr=rr)
    return engine(scene, job, sort=True)[1](it0, n_iters)


def engine(scene, job, split=None, sort=False, plain=False):
    """The engine that renders ``job`` (``megakernel.prepare``'s of
    ``scene``): (its name, ``run(it0, n)``, which returns the radiance
    (P,3) f32 summed over ``n`` samples from iteration ``it0`` and the
    counts (depth,) int64).  ``sort``: the sorted engine; else a
    ``split`` that is not None: the split engine at :func:`clamp_split`'s
    bounce, and K1 where that is 0 (depth 1); else K1.  With ``plain``,
    the route's plain versions, on the job's device."""
    if sort:
        box = sort_box(scene, job["cam"].device)

        def run(it0, n):
            return sorted_batch(job, it0, n, *box, plain=plain)
        return "sorted (K5)", run
    split = 0 if split is None else clamp_split(split, job["depth"])
    if split:
        def run(it0, n):
            return split_batch(job, it0, n, split, plain=plain)
        return f"split at {split} (K5, K6)", run

    def run(it0, n):
        if plain:
            return K.trace_plain(**job, it0=it0, n_spp=n)
        return K.trace_k1(job, it0, n)
    return "pallas (K1)", run
