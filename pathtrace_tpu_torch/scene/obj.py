"""Minimal Wavefront OBJ loader for the `mesh` geometry extension.

Covers the subset needed for "arbitrary mesh loading and rendering"
(reference README.md:113-117): ``v`` positions, ``vt`` texture
coordinates, and ``f`` faces (fan-triangulated, 1-based or negative
indices, ``v/vt/vn`` forms).  ``vt`` feeds the image texture-mapping
extra (README.md:103, PBRT 10.4) via barycentric interpolation.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Return (tri_verts (T,3,3) f32, tri_uv (T,3,2) f32 or None).

    ``tri_uv`` is None when the file has no ``vt`` data; faces that
    omit the vt slot in a file that has some default to uv (0,0).
    """
    verts = []
    uvs = []
    tris = []
    tri_uvs = []
    any_uv = False
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v" and len(parts) >= 4:
                verts.append(
                    [float(parts[1]), float(parts[2]), float(parts[3])]
                )
            elif parts[0] == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                uvi = []
                for tok in parts[1:]:
                    slots = tok.split("/")
                    i = int(slots[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                    if len(slots) > 1 and slots[1]:
                        j = int(slots[1])
                        uvi.append(j - 1 if j > 0 else len(uvs) + j)
                        any_uv = True
                    else:
                        uvi.append(-1)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    tri_uvs.append((uvi[0], uvi[k], uvi[k + 1]))
    if not tris:
        return np.zeros((0, 3, 3), dtype=np.float32), None
    v = np.asarray(verts, dtype=np.float32)
    t = np.asarray(tris, dtype=np.int64)
    tv = v[t]  # (T, 3, 3)
    if not any_uv or not uvs:
        # no vt data (a file may reference vt slots it never defines —
        # e.g. exporters that emit f v/vt with the vt block stripped)
        return tv, None
    uv_table = np.concatenate(
        [np.asarray(uvs, dtype=np.float32).reshape(-1, 2),
         np.zeros((1, 2), dtype=np.float32)],  # slot for missing (-1)
        axis=0,
    )
    tu = uv_table[np.asarray(tri_uvs, dtype=np.int64)]  # (T, 3, 2)
    return tv, tu.astype(np.float32)
