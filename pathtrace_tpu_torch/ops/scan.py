"""Work-efficient scan and stream compaction (K6).

Counterpart of ``pathtrace_tpu/ops/scan.py``, with its API:

* :func:`prefix_sum` -- the exclusive prefix sum of a 1-D tensor, returned
  as float32 as the reference's ``prefix_sum_pallas``.  The values are
  summed as int32 (a float is cast first), so the sum is exact for the
  0/1 masks and integer counts the reference supports (totals below
  2^24, where float32 holds every integer);
* :func:`compact_indices` -- the stable live-first partition of a mask:
  (perm int32, n_live), ``x[perm]`` holding the live elements in order,
  then the dead ones; the same permutation as ``argsort(~mask, stable)``.
  ``n_live`` stays a 0-d int32 tensor on the mask's device, so a caller
  on the card never waits for it;
* :func:`compact` -- a tensor, or a dict, list or tuple of tensors,
  gathered into that order.

On a CUDA tensor the scan launches K6 (``csrc/scan.cu``: GPU Gems 3
ch. 39's scan of tiles, their totals and the offsets added) and raises
if the build or the launch fails; on a CPU tensor it is the plain
version, :func:`prefix_sum_plain`, which takes the kernel's steps in
torch ops.  The scatter of ``arange`` to the slots is a torch op on
both, as the reference left it to XLA.
"""

from __future__ import annotations

from collections import Counter

import torch

# Values of one K6 tile (csrc/scan.cu kTile): the plain version's tiles.
TILE = 2048

# Launches of K6 (one per scan on a CUDA tensor), under "k6_scan".
LAUNCHES = Counter()


def prefix_sum_plain(x):
    """The exclusive prefix sum of int tensor ``x`` (1-D) in K6's steps:
    each tile's exclusive scan and total, the totals scanned (the same
    way, while there is more than one tile), each tile's offset added.
    Returns int32."""
    n = x.numel()
    n_tiles = -(-n // TILE)
    tiles = torch.nn.functional.pad(
        x.to(torch.int64), (0, n_tiles * TILE - n)).view(n_tiles, TILE)
    incl = torch.cumsum(tiles, dim=1)
    excl = incl - tiles
    if n_tiles > 1:
        excl = excl + prefix_sum_plain(incl[:, -1]).to(torch.int64)[:, None]
    return excl.reshape(-1)[:n].to(torch.int32)


def _scan_k6(x):
    """K6 on int32 CUDA tensor ``x``: its exclusive prefix sum, int32."""
    from .cuda import build
    from .cuda.megakernel import launch_error

    lib = build.load_k6()
    n = x.numel()
    out = torch.empty_like(x)
    scratch = torch.empty(lib.pt_k6_scratch(n), dtype=torch.int32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_k6_scan(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                             n, stream)
    launch_error("K6", lib, err)
    LAUNCHES["k6_scan"] += 1
    return out


def scan_int(x):
    """The exclusive prefix sum of the 1-D tensor ``x`` as int32 (``x``
    cast to int32 first): K6 on a CUDA tensor, :func:`prefix_sum_plain`
    on a CPU one."""
    if x.dim() != 1 or not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"scan: want a 1-D tensor of 1 .. 2^31-1 values, "
                         f"got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on cuda or cpu tensors, not {x.device}")
    return _scan_k6(x.to(torch.int32).contiguous())


def prefix_sum(x):
    """Exclusive prefix sum of a 1-D tensor, float32 (the reference's
    ``prefix_sum_pallas``); exact for 0/1 masks and integer counts whose
    total is below 2^24."""
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
