"""Vector / matrix helpers on float32 torch tensors.

Counterpart of ``pathtrace_tpu/core/vecmath.py``: the same conventions
(4x4 transforms act on column vectors, instance transform
``T @ Rx @ Ry @ Rz @ S`` with degrees, normals by the inverse-transpose)
and the same operation order, written as explicit f32 mul-adds so the
results round exactly as the reference's do.  Vectors are tensors whose
last axis has size 3; everything broadcasts.  A product's terms are
formed in one broadcast multiply and added left to right by
:func:`sum3`: each entry rounds as the reference's ``a0*b0 + a1*b1 +
a2*b2`` does, in a handful of tensor ops (no fused multiply-add, no
library matmul, whose summation order is its own).
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


def sum3(p):
    """``p[..., 0] + p[..., 1] + p[..., 2]``, added left to right."""
    x, y, z = p.unbind(-1)
    return x + y + z


def dot(a, b):
    return sum3(a * b)[..., None]


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
    """``(ay bz - az by, az bx - ax bz, ax by - ay bx)``: the axes
    rotated by one and by two."""
    return (torch.roll(a, -1, -1) * torch.roll(b, 1, -1)
            - torch.roll(a, 1, -1) * torch.roll(b, -1, -1))


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
    return sum3(m * v[..., None, :])


def mat3_mat(a, b):
    """(...,3,3) @ (...,3,3) -> (...,3,3), explicit f32 mul-adds."""
    x, y, z = (a[..., :, :, None] * b[..., None, :, :]).unbind(-2)
    return x + y + z


def transform_point(m, p):
    """Apply 4x4 ``m`` (...,4,4) to points ``p`` (...,3)."""
    return mat3_vec(m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    """Apply the linear part of ``m`` to directions (w = 0)."""
    return mat3_vec(m[..., :3, :3], d)


# Rx, Ry, Rz, entry by entry, as indices into their axis's
# (0, 1, cos, sin, -sin): axis a's values sit at 5a .. 5a + 4
_ROT_ENTRIES = torch.tensor([
    [[1, 0, 0], [0, 2, 4], [0, 3, 2]],
    [[7, 5, 8], [5, 6, 5], [9, 5, 7]],
    [[12, 14, 10], [13, 12, 10], [10, 10, 11]],
])


def _rotation(rotation_deg):
    """``Rx @ Ry @ Rz`` of the angles (degrees), (..., 3) -> (..., 3, 3)."""
    rad = rotation_deg * (PI / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    values = torch.stack([torch.zeros_like(c), torch.ones_like(c), c, s, -s],
                         dim=-1).flatten(-2)
    rx, ry, rz = values[..., _ROT_ENTRIES.to(values.device)].unbind(-3)
    return mat3_mat(mat3_mat(rx, ry), rz)


def homogeneous(m):
    """(..., 3, 4) -> (..., 4, 4), the bottom row (0, 0, 0, 1) added."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, bottom], dim=-2)


def _trs(rot, translation, scale):
    """The top three rows of :func:`trs_matrix`, from ``rot`` =
    :func:`_rotation`; (..., 3, 4)."""
    rs = rot * scale[..., None, :]  # R @ diag(scale)
    return torch.cat([rs, translation[..., :, None]], dim=-1)


def _trs_inv(rot, translation, scale, eps):
    """The top three rows of :func:`trs_inverse`, from ``rot``."""
    rt = rot.transpose(-1, -2)
    inv_s = 1.0 / (scale + torch.where(scale >= 0, eps, -eps))
    lin = rt * inv_s[..., :, None]  # diag(1/s) @ R^T
    trans = -mat3_vec(lin, translation)
    return torch.cat([lin, trans[..., :, None]], dim=-1)


def trs_matrix(translation, rotation_deg, scale):
    """``T @ Rx @ Ry @ Rz @ S`` (degrees); inputs (..., 3), output
    (..., 4, 4)."""
    return homogeneous(_trs(_rotation(rotation_deg), translation, scale))


def trs_inverse(translation, rotation_deg, scale, eps=1e-12):
    """Analytic inverse of :func:`trs_matrix`:
    ``S^-1 @ Rz^T Ry^T Rx^T @ T^-1``."""
    return homogeneous(_trs_inv(_rotation(rotation_deg), translation, scale,
                                 eps))


def trs_affine(translation, rotation_deg, scale, eps=1e-12):
    """(the top three rows of :func:`trs_matrix`, of :func:`trs_inverse`),
    (..., 3, 4) each, with the same bits, from one rotation."""
    rot = _rotation(rotation_deg)
    return (_trs(rot, translation, scale),
            _trs_inv(rot, translation, scale, eps))
