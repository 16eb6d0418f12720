"""Work-efficient scan and stream compaction (K6).

Counterpart of ``pathtrace_tpu/ops/scan.py``, with its API:

* :func:`prefix_sum` -- the exclusive prefix sum of a 1-D tensor, returned
  as float32 as the reference's ``prefix_sum_pallas``.  The values are
  summed as int32, so the sum is exact for the 0/1 masks and integer
  counts the reference supports (totals below 2^24, where float32 holds
  every integer); a float tensor must hold integers, and one that does
  not raises ``ValueError`` (the reference sums it in float32; K6 sums
  integers);
* :func:`compact_indices` -- the stable live-first partition of a mask:
  (perm int32, n_live), ``x[perm]`` holding the live elements in order,
  then the dead ones; the same permutation as ``argsort(~mask, stable)``.
  ``n_live`` stays a 0-d int32 tensor on the mask's device, so a caller
  on the card never waits for it;
* :func:`compact` -- a tensor, or a dict, list or tuple of tensors,
  gathered into that order.

On a CUDA tensor the scan launches K6 (``csrc/scan.cu``: one launch, a
decoupled look-back between tiles) and raises if the build or the launch
fails; on a CPU tensor it is the plain version, :func:`prefix_sum_plain`,
which takes the kernel's steps in torch ops.  The scatter of ``arange``
to the slots is a torch op on both, as the reference left it to XLA.
"""

from __future__ import annotations

from collections import Counter

import torch

# Values of one K6 tile (csrc/scan.cu kTile): the plain version's tiles.
TILE = 4096

# Launches of K6 (one per scan on a CUDA tensor), under "k6_scan".
LAUNCHES = Counter()

# K6's scratch per device index: [library, state (the ticket, then one
# status word per tile; int64, zeroed when made), tiles it holds, calls,
# the largest tag].
# Scans on one device run in stream order: two streams must not scan at
# once.
_K6 = {}


def prefix_sum_plain(x):
    """The exclusive prefix sum of int tensor ``x`` (1-D) in K6's steps:
    each tile's inclusive sums and its total (the aggregate), then the
    look-back, in tile order: each tile's exclusive prefix is its
    predecessor's plus that one's aggregate; each tile's values offset by
    it.  Returns int32 (wrapping past 2^31 - 1 as the kernel does)."""
    n = x.numel()
    n_tiles = -(-n // TILE)
    tiles = torch.nn.functional.pad(
        x.to(torch.int64), (0, n_tiles * TILE - n)).view(n_tiles, TILE)
    incl = torch.cumsum(tiles, dim=1)
    prefix, run = [], 0
    for agg in incl[:, -1].tolist():
        prefix.append(run)
        run += agg
    prefix = torch.tensor(prefix, dtype=torch.int64, device=x.device)
    return (incl - tiles + prefix[:, None]).reshape(-1)[:n].to(torch.int32)


def _k6_state(index, n_tiles):
    """K6's library and scratch for device ``index`` holding ``n_tiles``
    tiles, made (or grown, zeroed) here."""
    st = _K6.get(index)
    if st is None:
        from .cuda import build

        lib = build.load_k6()
        if lib.pt_k6_tile() != TILE:
            raise RuntimeError(f"K6 tiles of {lib.pt_k6_tile()} values, the "
                               f"plain version's of {TILE}")
        st = _K6[index] = [lib, None, 0, 0, lib.pt_k6_max_tag()]
    if n_tiles > st[2]:
        st[2] = max(n_tiles, 2 * st[2])
        st[1] = torch.zeros(1 + st[2], dtype=torch.int64,
                            device=torch.device("cuda", index))
    if st[3] >= st[4]:  # the tags start again on zeroed words
        st[1].zero_()
        st[3] = 0
    return st


def _stream(index):
    """The raw handle of device ``index``'s current stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return (raw(index) if raw is not None
            else torch.cuda.current_stream(index).cuda_stream)


def _scan_k6(x, n):
    """K6 on the ``n`` int32 values of contiguous CUDA tensor ``x``: its
    exclusive prefix sum, int32, in one launch, with no allocation but
    the output's.  The host path is one ``ctypes`` call: K6 is timed
    around it."""
    index = x.get_device()
    st = _K6.get(index)
    if st is None or n > st[2] * TILE or st[3] >= st[4]:
        st = _k6_state(index, -(-n // TILE))
    st[3] += 1
    out = torch.empty_like(x)
    if index == torch.cuda.current_device():
        err = st[0].pt_k6_scan(x.data_ptr(), out.data_ptr(),
                               st[1].data_ptr(), n, st[3], _stream(index))
    else:
        with torch.cuda.device(index):
            err = st[0].pt_k6_scan(x.data_ptr(), out.data_ptr(),
                                   st[1].data_ptr(), n, st[3],
                                   _stream(index))
    if err:
        from .cuda.megakernel import launch_error

        launch_error("K6", st[0], err)
    LAUNCHES["k6_scan"] += 1
    return out


def scan_int(x):
    """The exclusive prefix sum of the 1-D tensor ``x`` as int32 (``x``
    cast to int32 first): K6 on a CUDA tensor, :func:`prefix_sum_plain`
    on a CPU one."""
    n = x.numel()
    if x.dim() != 1 or not 0 < n < 2 ** 31:
        raise ValueError(f"scan: want a 1-D tensor of 1 .. 2^31-1 values, "
                         f"got shape {tuple(x.shape)}")
    if x.is_cuda:
        if x.dtype != torch.int32:
            x = x.to(torch.int32)
        return _scan_k6(x if x.is_contiguous() else x.contiguous(), n)
    if x.device.type != "cpu":
        raise ValueError(f"K6 runs on cuda or cpu tensors, not {x.device}")
    return prefix_sum_plain(x)


def prefix_sum(x):
    """Exclusive prefix sum of a 1-D tensor, float32 (the reference's
    ``prefix_sum_pallas``); exact for 0/1 masks and integer counts whose
    total is below 2^24.  The sum is K6's, over int32: a floating-point
    ``x`` must hold integers of int32's range, and raises ``ValueError``
    otherwise (a value such as 0.5, which the reference sums in float32,
    is not truncated)."""
    if x.is_floating_point() and x.numel() and not bool(
            ((x == torch.trunc(x)) & (x.abs() < 2.0 ** 31)).all()):
        raise ValueError("prefix_sum sums integers (K6 scans int32): a "
                         "float input must hold integer values below 2^31")
    return scan_int(x).to(torch.float32)


def compact_indices(mask, plain=False):
    """Stable-partition permutation of a bool mask: (``perm`` (N,) int32
    with the live indices in order first, the dead after; ``n_live``, a
    0-d int32 tensor), as the reference's ``compact_indices``: the scan
    gives each index its slot (live: the live before it; dead: n_live
    plus the dead before it), and one scatter of ``arange`` at the slots
    inverts that into the gather permutation.  With ``plain``, the scan is
    :func:`prefix_sum_plain` on any device."""
    mask = mask.to(torch.bool)
    m = mask.to(torch.int32)
    pos_live = prefix_sum_plain(m) if plain else scan_int(m)
    n_live = pos_live[-1] + m[-1]
    idx = torch.arange(m.numel(), dtype=torch.int32, device=m.device)
    slot = torch.where(mask, pos_live, n_live + (idx - pos_live))
    perm = torch.empty_like(idx)
    perm[slot.long()] = idx
    return perm, n_live


def compact(mask, payload):
    """Stream compaction: ``payload`` (a tensor, or a dict, list or tuple
    of them, each indexed on its first axis) gathered into the
    live-first order of :func:`compact_indices`.  Returns (dense payload,
    n_live)."""
    perm, n_live = compact_indices(mask)
    index = perm.long()

    def gather(a):
        if isinstance(a, dict):
            return {k: gather(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(gather(v) for v in a)
        return torch.as_tensor(a, device=index.device)[index]

    return gather(payload), n_live
