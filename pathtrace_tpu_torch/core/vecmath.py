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


def maximum(x, c):
    """max(x, c) for a constant ``c``, with the reference's derivative:
    half to each side on a tie, as ``jnp.maximum`` (``clamp_min`` passes
    all of it to ``x``).  ``c`` goes in as a CPU scalar: no copy to the
    device."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype))


def minimum(x, c):
    """min(x, c) for a constant ``c``, as :func:`maximum`."""
    return torch.minimum(x, torch.tensor(c, dtype=x.dtype))


def clip(x, lo, hi):
    """``jnp.clip``: half the derivative at either bound."""
    return minimum(maximum(x, lo), hi)


def norm(v):
    return torch.sqrt(dot(v, v))


def normalize(v, eps=0.0):
    """``v`` over its length, the length held at ``eps`` or above when
    ``eps`` is given (the reference's guard against a zero vector)."""
    n = norm(v)
    if eps:
        n = maximum(n, eps)
    return v / n


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def reflect(i, n):
    """GLM-convention reflection: i - 2 dot(n, i) n (``i`` points toward
    the surface)."""
    return i - 2.0 * dot(n, i) * n


def refract(i, n, eta):
    """GLM-convention refraction of incident ``i`` about normal ``n``
    (``eta`` of shape (..., 1)); the zero vector on total internal
    reflection, as ``glm::refract``.  The square root sees 1 where k < 0,
    so its derivative on those lanes is finite (the reference's guard)."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    valid = k >= 0.0
    refr = eta * i - (eta * cosi + torch.sqrt(torch.where(valid, k, 1.0))) * n
    return torch.where(valid, refr, torch.zeros_like(refr))


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


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


def transform_point(m, p):
    """Apply 4x4 ``m`` (...,4,4) to points ``p`` (...,3)."""
    return mat3_vec(m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    """Apply the linear part of ``m`` to directions (w = 0)."""
    return mat3_vec(m[..., :3, :3], d)


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
