"""K9, the BVH traversal probe: plain version and wrapper.

Counterpart of ``tools/probe_trav.py``: a fixed bundle of object-space
rays walks one geom's skip-link BVH as a single cursor (it enters a node
when any ray meets the node's box, and takes the skip link otherwise),
under a cap on the steps, and counts (final cursor, steps, leaves
fetched, float32 sum of column 0 of the fetched triangle rows truncated
to int32).  ``probe_plain`` is that walk in PyTorch; ``probe_k9``
launches the CUDA kernel ``csrc/probe_trav.cu`` for tensors on a GPU and
is ``probe_plain`` for tensors on the CPU.  The tables are ``pack_mesh``'s
(``tri``, ``nodes``) and one ``bvh_meta`` entry.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .bound import read as _read
from .megakernel import _slab

# Launches of the CUDA kernel (``probe_k9`` on a CUDA device).
LAUNCHES = Counter()

BUNDLE = (32, 128)  # rows, lanes: the reference's (8,128)-tiled ray tile
MAX_STEPS = 200000
MAX_RAYS = 4096  # the kernel's cluster holds 4096 rays


def bundle_rays(rows, lanes, device="cpu"):
    """The probe's rays, (origin (3,), 1/direction (3,)) each a (rows *
    lanes,) float32 tensor: ray (row, lane) starts at (-3 + 0.01 row,
    0.005 lane - 0.3, 0) along (1, 0.001 row, 0.0005 lane) / |.|,
    rounded as the reference computes it (square root correctly rounded,
    IEEE divisions)."""
    row = torch.arange(rows, dtype=torch.float32, device=device)
    lane = torch.arange(lanes, dtype=torch.float32, device=device)
    row, lane = (t.reshape(-1) for t in torch.meshgrid(row, lane,
                                                       indexing="ij"))
    ox = -3.0 + row * 0.01
    oy = lane * 0.005 - 0.3
    oz = torch.zeros_like(row)
    dx, dy, dz = torch.ones_like(row), row * 0.001, lane * 0.0005
    n2 = torch.sqrt((dx * dx + dy * dy + dz * dz).double()).float()
    one = torch.ones_like(row)
    return (ox, oy, oz), tuple(one / (d / n2) for d in (dx, dy, dz))


def probe_plain(nodes, tri, entry, rows=BUNDLE[0], lanes=BUNDLE[1],
                max_steps=MAX_STEPS):
    """K9 in plain PyTorch on the device of ``nodes``: (n, steps,
    leaves, tsum) of the bundle's walk over the geom ``entry`` = (g,
    node_off, n_nodes, tri_off, n_tris) of ``bvh_meta``."""
    _, node_off, n_nodes, tri_off, _ = entry
    o, ird = bundle_rays(rows, lanes, nodes.device)
    table = nodes[node_off:node_off + n_nodes].tolist()
    col0 = tri[tri_off:, 0].cpu().numpy()
    n = steps = leaves = 0
    tsum = np.float32(0.0)
    while n < n_nodes and steps < max_steps:
        node = table[n]
        _read(nodes, "k9 nodes", node_off + n, 9)
        tnear = torch.zeros_like(o[0])  # the max with 0
        tfar = torch.full_like(o[0], float("inf"))
        for ax in range(3):
            ta, tb = _slab(node[ax], node[3 + ax], o[ax], ird[ax])
            tnear, tfar = torch.maximum(tnear, ta), torch.minimum(tfar, tb)
        any_hit = bool(((tnear <= tfar) & (tnear < 1e10)).any())
        skip, start, count = (int(x) for x in node[6:9])
        if count > 0 and any_hit:
            leaves += 1
            _read(tri, "k9 tri", range(tri_off + start,
                                       tri_off + start + count), 1)
            for j in range(start, start + count):
                tsum = np.float32(tsum + col0[j])
        n = skip if count > 0 or not any_hit else n + 1
        steps += 1
    return n, steps, leaves, int(tsum)


def probe_k9(nodes, tri, entry, rows=BUNDLE[0], lanes=BUNDLE[1],
             max_steps=MAX_STEPS):
    """K9: the result of :func:`probe_plain`.  For tensors on the CPU
    this is :func:`probe_plain`; on a CUDA device it launches the kernel
    of ``csrc/probe_trav.cu`` (building it at first use) and raises if
    the build or the launch fails."""
    device = nodes.device
    if device.type == "cpu":
        return probe_plain(nodes, tri, entry, rows, lanes, max_steps)
    if device.type != "cuda":
        raise ValueError(f"K9 runs on cuda or cpu tensors, not {device}")
    from . import build

    _, node_off, n_nodes, tri_off, n_tris = entry
    if not 0 < rows * lanes <= MAX_RAYS:
        raise ValueError(f"K9 takes 1 to {MAX_RAYS} rays, not "
                         f"{rows}x{lanes}")
    for name, t, n_rows in (("nodes", nodes, node_off + n_nodes),
                            ("tri", tri, tri_off + n_tris)):
        if (t.device != device or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[1] != 16 or t.shape[0] < n_rows
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: want a contiguous, 16-byte aligned "
                             f"float32 (>= {n_rows}, 16) tensor on {device}")
    out = torch.empty(4, dtype=torch.int32, device=device)
    # the leaves fetched, (start, count) each: at most one a node
    leaf_list = torch.empty((n_nodes, 2), dtype=torch.int32, device=device)
    lib = build.load_k9()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_k9_probe(nodes[node_off].data_ptr(),
                              tri[tri_off].data_ptr(), n_nodes, rows, lanes,
                              max_steps, leaf_list.data_ptr(),
                              out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K9 launch failed: CUDA error {err} "
            f"({lib.pt_cuda_error_string(err).decode()})")
    LAUNCHES["k9_probe"] += 1
    return tuple(out.tolist())
