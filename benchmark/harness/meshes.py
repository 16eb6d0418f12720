"""OBJ meshes that a configuration names by generator, written in the
run's set-up: the subdivided icosahedron of the repository's
``tools/gen_mesh.py`` (level L: 20 * 4^L triangles), the same file byte
for byte, made with array operations in a fraction of that script's
time.  A configuration states the file's SHA-256, and :func:`write`
refuses a file that does not match it."""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _icosahedron():
    t = (1.0 + 5 ** 0.5) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def _subdivide(v, f):
    """One 4-way split, each new edge midpoint numbered in the order the
    faces first meet it and projected to the unit sphere."""
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    # the edges in the order the faces visit them: (a,b), (b,c), (c,a)
    e = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                  np.stack([c, a], 1)], 1).reshape(-1, 2)
    key = np.sort(e, axis=1)
    code = key[:, 0] * (len(v) + 1) + key[:, 1]
    uniq, first, inv = np.unique(code, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    mid_id = len(v) + rank[inv].reshape(-1, 3)
    pick = e[np.sort(first)]
    m = v[pick[:, 0]] + v[pick[:, 1]]
    m = m / np.sqrt(np.einsum("ij,ij->i", m, m))[:, None]
    ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
    nf = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                   np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)], 1)
    return np.concatenate([v, m]), nf.reshape(-1, 3)


def icosphere(level):
    v, f = _icosahedron()
    for _ in range(level):
        v, f = _subdivide(v, f)
    return v, f


def obj_text(v, f):
    lines = [f"# icosphere {f.shape[0]} tris\n"]
    lines += ["v %.7f %.7f %.7f\n" % tuple(p) for p in v]
    lines += ["f %d %d %d\n" % tuple(t) for t in (f + 1)]
    return "".join(lines)


GENERATORS = {"icosphere": lambda spec: obj_text(*icosphere(spec["level"]))}


def write(spec, path):
    """Writes the OBJ of ``spec`` (``{"generator": ..., "sha256": ...}``
    and the generator's parameters) to ``path``; raises ``ValueError`` if
    its hash is not the one stated."""
    data = GENERATORS[spec["generator"]](spec).encode()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"mesh {spec}: sha256 {digest} is not the one the "
                         f"configuration states")
    tmp = f"{path}.part"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)
