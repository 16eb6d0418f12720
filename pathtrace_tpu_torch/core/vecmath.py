"""Vector / matrix helpers on float32 torch tensors.

Counterpart of ``pathtrace_tpu/core/vecmath.py``: the same conventions
(4x4 transforms act on column vectors, instance transform
``T @ Rx @ Ry @ Rz @ S`` with degrees, normals by the inverse-transpose)
and the same operation order, written as explicit f32 mul-adds so the
results round exactly as the reference's do.  Vectors are tensors whose
last axis has size 3; everything broadcasts.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import PI


def as_f32(x):
    """A float32 CPU tensor holding ``x``, the input of the scene-side
    math: a tensor as it is (moved to the CPU or cast to float32 only if
    it is not, both differentiable, so its graph carries on), an array
    or nested sequences converted."""
    if isinstance(x, torch.Tensor):
        return x.to(device="cpu", dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])[..., None]


def normalize(v):
    return v / torch.sqrt(dot(v, v))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def mat3_vec(m, v):
    """(...,3,3) @ (...,3) -> (...,3), explicit f32 mul-adds."""
    return torch.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)],
        dim=-1,
    )


def mat3_mat(a, b):
    """(...,3,3) @ (...,3,3) -> (...,3,3), explicit f32 mul-adds."""
    rows = [
        torch.stack(
            [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
             + a[..., i, 2] * b[..., 2, j] for j in range(3)],
            dim=-1,
        )
        for i in range(3)
    ]
    return torch.stack(rows, dim=-2)


def _rot_axis(c, s, axis):
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    if axis == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rotation(rotation_deg):
    rad = rotation_deg * (PI / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    r = _rot_axis(c[..., 0], s[..., 0], 0)
    r = mat3_mat(r, _rot_axis(c[..., 1], s[..., 1], 1))
    return mat3_mat(r, _rot_axis(c[..., 2], s[..., 2], 2))


def _homogeneous(m):
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, bottom], dim=-2)


def trs_matrix(translation, rotation_deg, scale):
    """``T @ Rx @ Ry @ Rz @ S`` (degrees); inputs (..., 3), output
    (..., 4, 4)."""
    rs = _rotation(rotation_deg) * scale[..., None, :]  # R @ diag(scale)
    return _homogeneous(torch.cat([rs, translation[..., :, None]], dim=-1))


def trs_inverse(translation, rotation_deg, scale, eps=1e-12):
    """Analytic inverse of :func:`trs_matrix`:
    ``S^-1 @ Rz^T Ry^T Rx^T @ T^-1``."""
    rt = _rotation(rotation_deg).transpose(-1, -2)
    inv_s = 1.0 / (scale + torch.where(scale >= 0, eps, -eps))
    lin = rt * inv_s[..., :, None]  # diag(1/s) @ R^T
    trans = -mat3_vec(lin, translation)
    return _homogeneous(torch.cat([lin, trans[..., :, None]], dim=-1))
