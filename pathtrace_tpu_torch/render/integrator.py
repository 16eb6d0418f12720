"""Camera basis and geom transforms in float32 torch.

Counterpart of the two helpers of ``pathtrace_tpu/render/integrator.py``
that the megakernel's table packing uses; the rest of that module (the
wavefront integrator) is not ported yet (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.constants import PI
from ..core.vecmath import as_f32 as _f32


def camera_basis(camera, width, height):
    """(view, right, up, tan_fovx, tan_fovy), fovx derived from fovy and
    the aspect ratio as src/scene.cpp:133-136 does."""
    view = vm.normalize(_f32(camera.view))
    right = vm.normalize(vm.cross(view, _f32(camera.up)))
    up = vm.normalize(vm.cross(right, view))
    tan_y = torch.tan(_f32(camera.fovy_deg) * (PI / 180.0))
    tan_x = tan_y * (width / height)
    return view, right, up, tan_x, tan_y


def geom_transforms(geoms):
    """TRS -> (forward, inverse, inverse-transpose), (G,4,4) each — the
    precompute of src/scene.cpp:82-85."""
    t, r, s = (_f32(geoms.translation), _f32(geoms.rotation),
               _f32(geoms.scale))
    fwd = vm.trs_matrix(t, r, s)
    inv = vm.trs_inverse(t, r, s)
    return fwd, inv, inv.transpose(-1, -2)


def triangle_uv_gradients(tri_verts, tri_uv):
    """Per-triangle object-space gradients of the UV chart: (grad_u
    (T,3), grad_v (T,3)) float32.  On a triangle (u, v) are affine in
    position, so ``g_u`` is the in-plane vector with ``g_u . e1 = du1``
    and ``g_u . e2 = du2``, solved through the 2x2 Gram system of the
    edges.  A zero-area face or a zero UV area gives zero gradients (the
    BUMPTEX tilt is then off there, never NaN)."""
    tv, uv = _f32(tri_verts), _f32(tri_uv)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]

    def dot(a, b):
        p = a * b
        return (p[:, 0] + p[:, 1]) + p[:, 2]

    g11, g12, g22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    det = g11 * g22 - g12 * g12
    ok = torch.abs(det) > 1e-20
    inv_det = torch.where(
        ok, torch.reciprocal(torch.where(ok, det, 1.0)), 0.0)
    a_u = (g22 * du1 - g12 * du2) * inv_det
    b_u = (g11 * du2 - g12 * du1) * inv_det
    a_v = (g22 * dv1 - g12 * dv2) * inv_det
    b_v = (g11 * dv2 - g12 * dv1) * inv_det
    return (a_u[:, None] * e1 + b_u[:, None] * e2,
            a_v[:, None] * e1 + b_v[:, None] * e2)
