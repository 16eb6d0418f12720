"""Host-side BVH build for triangle meshes (per geom, object space).

Counterpart of ``pathtrace_tpu/scene/bvh.py``, the same numpy code, so
that the tree (nodes, triangle order and per-geom offsets) is bit-equal
to the reference's.  One median-split BVH per MESH geom over that geom's
triangles in *object* space, which makes the tree invariant under the
instance transform and under MOTION (the kernel moves the ray, not the
mesh).  Nodes are laid out in DFS pre-order with *skip links* (the index
of the first node after the subtree), so a traversal is one cursor,
``n = hit ? n+1 : skip[n]``, with no stack; leaves hold up to
:data:`LEAF_K` triangles, contiguous in the reordered triangle table.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

# Max triangles per leaf.
LEAF_K = 8

# Node record, 9 float32 columns of an (N, 16) table: [0:3] aabb min,
# [3:6] aabb max, [6] skip link, [7] leaf tri start (row in the geom's
# reordered tri table), [8] leaf tri count (0 => internal node).
NODE_COLS = 16


def _build_one(lo, hi, cent, idx, nodes, order):
    """DFS pre-order build over triangle subset ``idx`` (indices into
    the geom's tri array): appends node records and reordered tri ids."""
    my = len(nodes)
    bmin = lo[idx].min(axis=0)
    bmax = hi[idx].max(axis=0)
    if len(idx) <= LEAF_K:
        start = len(order)
        order.extend(int(i) for i in idx)
        nodes.append([*bmin, *bmax, 0.0, float(start), float(len(idx))])
    else:
        nodes.append([*bmin, *bmax, 0.0, 0.0, 0.0])
        axis = int(np.argmax(bmax - bmin))
        srt = idx[np.argsort(cent[idx, axis], kind="stable")]
        half = len(srt) // 2
        _build_one(lo, hi, cent, srt[:half], nodes, order)
        _build_one(lo, hi, cent, srt[half:], nodes, order)
    nodes[my][6] = float(len(nodes))  # skip = first node after subtree


def build_geom_bvh(tv):
    """BVH over triangles ``tv`` (t, 3, 3) in object space: (nodes (N,
    NODE_COLS) f32, order (t,) int32), ``order[slot]`` the original
    triangle index stored at reordered row ``slot``."""
    t = tv.shape[0]
    if t == 0:
        return (np.zeros((0, NODE_COLS), np.float32),
                np.zeros((0,), np.int32))
    lo = tv.min(axis=1)
    hi = tv.max(axis=1)
    cent = (lo + hi) * 0.5
    nodes: list = []
    order: list = []
    # recursion depth ~log2(t/LEAF_K); lift the cap for big meshes
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 64 + 4 * int(np.ceil(np.log2(t + 1)))))
    try:
        _build_one(lo, hi, cent, np.arange(t), nodes, order)
    finally:
        sys.setrecursionlimit(old)
    out = np.zeros((len(nodes), NODE_COLS), np.float32)
    out[:, :9] = np.asarray(nodes, np.float32)[:, :9]
    return out, np.asarray(order, np.int32)


def build_mesh_bvh(tri_verts, tri_geom, geom_count):
    """Per-geom BVHs over a concatenated triangle soup: (nodes (N_total,
    NODE_COLS) f32, every geom's table concatenated; order (T,) int32,
    new row -> original tri index; meta, one static entry ``(g,
    node_off, n_nodes, tri_off, n_tris)`` per geom ``g`` that owns
    triangles).  Skip links and leaf starts are relative to the geom's
    ``node_off`` and ``tri_off``."""
    tri_geom = np.asarray(tri_geom)
    nodes_all, order_all, meta = [], [], []
    node_off = tri_off = 0
    for g in range(geom_count):
        sel = np.nonzero(tri_geom == g)[0]
        if sel.size == 0:
            continue
        nodes, order = build_geom_bvh(np.asarray(tri_verts)[sel])
        nodes_all.append(nodes)
        order_all.append(sel[order].astype(np.int32))
        meta.append((int(g), int(node_off), int(nodes.shape[0]),
                     int(tri_off), int(sel.size)))
        node_off += nodes.shape[0]
        tri_off += sel.size
    if not meta:
        return (np.zeros((0, NODE_COLS), np.float32),
                np.zeros((0,), np.int32), ())
    return (np.concatenate(nodes_all, axis=0),
            np.concatenate(order_all, axis=0), tuple(meta))


def with_bvh(mesh, geom_count):
    """``mesh`` (``core.types.TriMesh``) with its ``bvh_*`` fields built
    (unchanged when it is empty or already has them)."""
    if mesh.count == 0 or mesh.bvh_meta:
        return mesh
    nodes, order, meta = build_mesh_bvh(mesh.tri_verts, mesh.tri_geom,
                                        geom_count)
    return dataclasses.replace(mesh, bvh_nodes=nodes, bvh_order=order,
                               bvh_meta=meta)


def without_bvh(scene):
    """``scene`` with its mesh stripped of the ``bvh_*`` fields (the
    reference's ``use_bvh=False``): it packs the form that K3-linear folds,
    every triangle in index order."""
    return dataclasses.replace(scene, mesh=dataclasses.replace(
        scene.mesh, bvh_nodes=None, bvh_order=None, bvh_meta=()))
