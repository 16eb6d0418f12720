"""Area-light tables for next-event estimation (NEE), in float32 torch.

Counterpart of the table half of ``pathtrace_tpu/ops/lights.py``: the
per-face geometry of a cube light and the ``|det M3|`` of a sphere light,
which ``ops/cuda/megakernel.pack_lights`` writes into the light table
that the NEE section of the megakernel samples.  Sums of three or six
terms are written out left to right, as the reference's reductions add
them.
"""

from __future__ import annotations

import torch


def _col(m, j):
    """j-th column of the linear part of a (4,4) transform, (3,)."""
    return m[:3, j]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _sum3(v):
    return v[0] + v[1] + v[2]


def cube_light_tables(fwd_g):
    """Per-face (origin, edge_b, edge_c, outward normal, area) for the 6
    faces of a transformed unit cube.  ``fwd_g``: (4,4) float32.  Returns
    a dict of (6,3) / (6,) tensors, faces in the order +x, -x, +y, -y,
    +z, -z."""
    cols = [_col(fwd_g, j) for j in range(3)]
    trans = fwd_g[:3, 3]
    origins, e_bs, e_cs, normals, areas = [], [], [], [], []
    for axis in range(3):
        b, c = (axis + 1) % 3, (axis + 2) % 3
        cross = _cross(cols[b], cols[c])
        area = torch.sqrt(_sum3(cross * cross))
        for sign in (1.0, -1.0):
            center = trans + cols[axis] * (0.5 * sign)
            # orient the plane normal cross(Mb, Mc) outward: along
            # sign * (world direction of +axis)
            orient = _sum3(cross * cols[axis])
            n = cross * (torch.where(orient >= 0, 1.0, -1.0) * sign)
            n = n / torch.clamp_min(torch.sqrt(_sum3(n * n)), 1e-20)
            origins.append(center)
            e_bs.append(cols[b])
            e_cs.append(cols[c])
            normals.append(n)
            areas.append(area)
    return dict(origin=torch.stack(origins), e_b=torch.stack(e_bs),
                e_c=torch.stack(e_cs), normal=torch.stack(normals),
                area=torch.stack(areas))


def sphere_det3(fwd_g):
    """|det| of the linear 3x3 part of a (4,4) transform, ()."""
    c0, c1, c2 = (_col(fwd_g, j) for j in range(3))
    return torch.abs(_sum3(c0 * _cross(c1, c2)))
