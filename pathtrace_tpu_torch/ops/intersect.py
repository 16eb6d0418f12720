"""Batched ray-primitive intersection, in float32 torch.

Counterpart of ``pathtrace_tpu/ops/intersect.py`` (the role of the
reference's ``src/intersections.h``), with its semantics:

* unit primitives under instance transforms: the cube is [-0.5, 0.5]^3,
  the sphere has radius 0.5;
* the object-space ray direction is normalized again after the inverse
  transform, so object-space t values are object-space distances;
* the hit point backs off the surface by 1e-4 *in object space* along
  the normalized object ray (``getPointOnRay``);
* the distance compared for the nearest hit is the **world-space
  distance** from the ray origin to the (backed-off) world hit point;
* inside hits flip the reported normal toward the incoming ray and
  report ``outside`` False;
* the box transforms its normal by the *forward* transform, the sphere
  and the triangles by the inverse-transpose (a quirk of the reference,
  kept);
* a zero direction component divides into IEEE inf: the slabs are not
  guarded.

Every transform is applied as explicit float32 mul-adds in the
reference's order, never ``einsum`` or ``matmul``: on the card those may
run on TF32 tensor cores, which would move the thin cornell walls.
"""

from __future__ import annotations

import torch

from ..core import types as T
from ..core import vecmath as vm
from ..core.constants import NO_HIT, PI, RAY_OFFSET


def _rows_apply(m3, v):
    """m3 (G,3,3) applied to v (N,3) -> (N,G,3), explicit mul-adds."""
    vx, vy, vz = v[:, None, 0], v[:, None, 1], v[:, None, 2]
    return torch.stack(
        [m3[None, :, i, 0] * vx + m3[None, :, i, 1] * vy
         + m3[None, :, i, 2] * vz for i in range(3)],
        dim=-1,
    )


def _pair_apply(m3, v):
    """m3 (G,3,3) applied to v (N,G,3) -> (N,G,3), explicit mul-adds."""
    return torch.stack(
        [m3[None, :, i, 0] * v[..., 0] + m3[None, :, i, 1] * v[..., 1]
         + m3[None, :, i, 2] * v[..., 2] for i in range(3)],
        dim=-1,
    )


def _transform_rays(inv, origins, dirs):
    """Rays to the object space of each geom: origins and dirs (N,3), inv
    (G,4,4) -> (N,G,3) object origins and *normalized* directions."""
    ro = _rows_apply(inv[:, :3, :3], origins) + inv[:, :3, 3][None]
    rd = vm.normalize(_rows_apply(inv[:, :3, :3], dirs))
    return ro, rd


def _slab_normals(ro, rd):
    """The slab test of unit cubes: (t_use, n_obj, hit, inside, axis),
    the axis of the face hit, over any leading shape (..., 3)."""
    t1 = (-0.5 - ro) / rd
    t2 = (0.5 - ro) / rd
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    axis_sign = torch.where(t2 < t1, 1.0, -1.0)  # per-axis normal sign
    # tmin: the largest ta > 0; tmax: the smallest tb (first axis on ties)
    ta_m = torch.where(ta > 0, ta, -1e38)
    tmin = torch.amax(ta_m, dim=-1)
    near_axis = torch.argmax(ta_m, dim=-1)
    tmax = torch.amin(tb, dim=-1)
    far_axis = torch.argmin(tb, dim=-1)

    lanes = torch.arange(3, device=ro.device)

    def axis_normal(axis):
        one_hot = (axis[..., None] == lanes).to(ro.dtype)
        return one_hot * torch.gather(axis_sign, -1, axis[..., None])

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_use = torch.where(inside, tmax, tmin)
    n_obj = torch.where(inside[..., None], axis_normal(far_axis),
                        axis_normal(near_axis))
    return t_use, n_obj, hit, inside, torch.where(inside, far_axis,
                                                  near_axis)


def intersect_boxes(origins, dirs, fwd, inv):
    """Slab test against unit cubes: (dist (N,G), point (N,G,3), normal
    (N,G,3), outside (N,G)); dist is NO_HIT on a miss."""
    ro, rd = _transform_rays(inv, origins, dirs)
    t_use, n_obj, hit, inside, _ = _slab_normals(ro, rd)
    p_obj = ro + (t_use[..., None] - RAY_OFFSET) * rd
    point = _pair_apply(fwd[:, :3, :3], p_obj) + fwd[:, :3, 3][None]
    # the reference's quirk: the normal through the *forward* transform
    normal = vm.normalize(_pair_apply(fwd[:, :3, :3], n_obj))
    dist = vm.norm(origins[:, None, :] - point)[..., 0]
    return torch.where(hit, dist, NO_HIT), point, normal, hit & ~inside


def _sphere_roots(ro, rd):
    """(t_use, outside_raw, hit) of the radius-0.5 unit sphere."""
    v_dot_d = torch.sum(ro * rd, dim=-1)
    radicand = v_dot_d * v_dot_d - (torch.sum(ro * ro, dim=-1) - 0.25)
    has_root = radicand >= 0
    sq = torch.sqrt(torch.where(has_root, radicand, 1.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_use = torch.where(both_pos, torch.minimum(t1, t2),
                        torch.maximum(t1, t2))
    return t_use, both_pos, has_root & ~both_neg


def intersect_spheres(origins, dirs, fwd, inv, inv_t):
    """Quadratic test against unit spheres (radius 0.5); returns as
    :func:`intersect_boxes`."""
    ro, rd = _transform_rays(inv, origins, dirs)
    t_use, outside_raw, hit = _sphere_roots(ro, rd)
    p_obj = ro + (t_use[..., None] - RAY_OFFSET) * rd
    point = _pair_apply(fwd[:, :3, :3], p_obj) + fwd[:, :3, 3][None]
    normal = vm.normalize(_pair_apply(inv_t[:, :3, :3], p_obj), eps=1e-20)
    normal = torch.where(outside_raw[..., None], normal, -normal)
    dist = vm.norm(origins[:, None, :] - point)[..., 0]
    return torch.where(hit, dist, NO_HIT), point, normal, hit & outside_raw


def _moller_trumbore(ro, rd, v0, e1, e2):
    """Möller-Trumbore on object-space rays (..., 3) against a triangle
    (v0, e1 = v1 - v0, e2 = v2 - v0), broadcast: (u, v, t, hit)."""
    pvec = vm.cross(rd, e2.expand(rd.shape))
    det = torch.sum(pvec * e1, dim=-1)
    ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = vm.cross(tvec, e1.expand(tvec.shape))
    v = torch.sum(rd * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return u, v, t, hit


def intersect_triangles(origins, dirs, tri_verts, tri_geom, fwd, inv,
                        inv_t):
    """Möller-Trumbore against object-space triangles (T,3,3) instanced
    by the geoms ``tri_geom`` (T,): returns as :func:`intersect_boxes`,
    with a T axis in place of G, under the same conventions (object-space
    normalize, back-off, world distance)."""
    tri_geom = torch.as_tensor(tri_geom, dtype=torch.int64,
                               device=tri_verts.device)
    inv_g, fwd_g, inv_t_g = inv[tri_geom], fwd[tri_geom], inv_t[tri_geom]
    ro, rd = _transform_rays(inv_g, origins, dirs)
    v0, v1, v2 = tri_verts[:, 0], tri_verts[:, 1], tri_verts[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    _, _, t, hit = _moller_trumbore(ro, rd, v0[None], e1[None], e2[None])
    p_obj = ro + (t[..., None] - RAY_OFFSET) * rd
    point = _pair_apply(fwd_g[:, :3, :3], p_obj) + fwd_g[:, :3, 3][None]
    n_obj = vm.normalize(vm.cross(e1, e2)[None].expand(rd.shape), eps=1e-20)
    outside_raw = torch.sum(rd * n_obj, dim=-1) < 0.0
    n_obj = torch.where(outside_raw[..., None], n_obj, -n_obj)
    normal = vm.normalize(_pair_apply(inv_t_g[:, :3, :3], n_obj), eps=1e-20)
    dist = vm.norm(origins[:, None, :] - point)[..., 0]
    return torch.where(hit, dist, NO_HIT), point, normal, hit & outside_raw


def _mat3_rows(m4, v, translate=False):
    """The linear part of (4,4) ``m4`` applied to (N,3), explicit
    mul-adds, plus its translation if ``translate``."""
    return torch.stack(
        [m4[i, 0] * v[:, 0] + m4[i, 1] * v[:, 1] + m4[i, 2] * v[:, 2]
         + (m4[i, 3] if translate else 0.0) for i in range(3)],
        dim=-1,
    )


def _one_box(origins, dirs, fwd_g, inv_g, want_uv=False):
    """The slab test against one unit cube, every temporary (N,3) or
    (N,): (dist, point, normal, outside), and with ``want_uv`` a (N,2)
    face-planar UV: the face is the dominant axis of the object normal,
    and the other two object coordinates + 0.5 are (u, v): x faces (z, y),
    y faces (x, z), z faces (x, y)."""
    ro = _mat3_rows(inv_g, origins, translate=True)
    rd = vm.normalize(_mat3_rows(inv_g, dirs))
    t_use, n_obj, hit, inside, axis = _slab_normals(ro, rd)
    p_obj = ro + (t_use[:, None] - RAY_OFFSET) * rd
    point = _mat3_rows(fwd_g, p_obj, translate=True)
    # the reference's quirk: the normal through the FORWARD transform
    normal = vm.normalize(_mat3_rows(fwd_g, n_obj))
    dist = vm.norm(origins - point)[..., 0]
    out = (torch.where(hit, dist, NO_HIT), point, normal, hit & ~inside)
    if want_uv:
        px, py, pz = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
        u = torch.where(axis == 0, pz, px) + 0.5
        v = torch.where(axis == 1, pz, py) + 0.5
        out = out + (torch.stack([u, v], dim=-1),)
    return out


def _one_sphere(origins, dirs, fwd_g, inv_g, inv_t_g, want_uv=False):
    """The quadratic test against one unit sphere, every temporary (N,3)
    or (N,); returns as :func:`_one_box`, the UV spherical on the radius
    0.5 sphere: u = 0.5 + atan2(z, x) / 2pi, v = 0.5 + asin(2y) / pi."""
    ro = _mat3_rows(inv_g, origins, translate=True)
    rd = vm.normalize(_mat3_rows(inv_g, dirs))
    t_use, outside_raw, hit = _sphere_roots(ro, rd)
    p_obj = ro + (t_use[:, None] - RAY_OFFSET) * rd
    point = _mat3_rows(fwd_g, p_obj, translate=True)
    normal = vm.normalize(_mat3_rows(inv_t_g, p_obj), eps=1e-20)
    normal = torch.where(outside_raw[:, None], normal, -normal)
    dist = vm.norm(origins - point)[..., 0]
    out = (torch.where(hit, dist, NO_HIT), point, normal, hit & outside_raw)
    if want_uv:
        u = 0.5 + torch.atan2(p_obj[:, 2], p_obj[:, 0]) / (2.0 * PI)
        v = 0.5 + torch.asin(vm.clip(2.0 * p_obj[:, 1], -1.0, 1.0)) / PI
        out = out + (torch.stack([u, v], dim=-1),)
    return out


def _intersect_one_triangle(origins, dirs, tri, fwd_g, inv_g, inv_t_g,
                            uv3=None):
    """Möller-Trumbore for one triangle (3,3) against (N,) rays, under
    :func:`intersect_triangles`' conventions: (dist, point, normal,
    outside), and with ``uv3`` (3,2), the corners' texture coordinates,
    the barycentric-interpolated (N,2) UV."""
    ro = _mat3_rows(inv_g, origins, translate=True)
    rd = vm.normalize(_mat3_rows(inv_g, dirs))
    v0, v1, v2 = tri[0], tri[1], tri[2]
    e1, e2 = v1 - v0, v2 - v0
    u, v, t, hit = _moller_trumbore(ro, rd, v0[None], e1[None], e2[None])
    p_obj = ro + (t[:, None] - RAY_OFFSET) * rd
    point = _mat3_rows(fwd_g, p_obj, translate=True)
    n_obj = vm.normalize(vm.cross(e1, e2), eps=1e-20)
    n_obj_b = n_obj[None].expand(rd.shape)
    outside_raw = torch.sum(rd * n_obj_b, dim=-1) < 0.0
    n_obj_b = torch.where(outside_raw[:, None], n_obj_b, -n_obj_b)
    normal = vm.normalize(_mat3_rows(inv_t_g, n_obj_b), eps=1e-20)
    dist = vm.norm(origins - point)[..., 0]
    out = (torch.where(hit, dist, NO_HIT), point, normal, outside_raw & hit)
    if uv3 is not None:
        w = 1.0 - u - v
        out = out + (torch.stack(
            [w * uv3[0, 0] + u * uv3[1, 0] + v * uv3[2, 0],
             w * uv3[0, 1] + u * uv3[1, 1] + v * uv3[2, 1]], dim=-1),)
    return out


# the raw barycentric chart of a triangle without vt data
BARY_UV = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))


def _fold_triangles(fold, origins, dirs, tri_verts, tri_geom, fwd, inv,
                    inv_t, velocity=None, time=None, tri_uv=None,
                    want_uv=False, tri_tang=None):
    """Fold the mesh triangles into the running minimum, one triangle
    after another in index order (the reference's ``lax.scan``), so the
    first triangle wins a tie; every temporary (N,3) or (N,).
    ``tri_geom`` is read on the host: each triangle's transforms are rows
    picked by a Python index (no gather, so no scatter in the backward
    pass)."""
    geom_of = [int(g) for g in torch.as_tensor(tri_geom).tolist()]
    if want_uv and tri_uv is None:
        tri_uv = torch.tensor(BARY_UV, dtype=origins.dtype,
                              device=origins.device)[None].expand(
            tri_verts.shape[0], 3, 2)
    n = origins.shape[0]
    for t, g in enumerate(geom_of):
        o_t = origins
        if velocity is not None:
            o_t = origins - time[:, None] * velocity[g][None]
        res = _intersect_one_triangle(o_t, dirs, tri_verts[t], fwd[g],
                                      inv[g], inv_t[g],
                                      tri_uv[t] if want_uv else None)
        p = res[1]
        if velocity is not None:
            p = p + time[:, None] * velocity[g][None]
        tang = (tri_tang[t][None].expand(n, 6) if tri_tang is not None
                else None)
        fold(res[0], p, res[2], res[3], g, res[4] if want_uv else None,
             tang)


def intersect_scene(origins, dirs, geom_type, fwd, inv, inv_t,
                    tri_verts=None, tri_geom=None, velocity=None, time=None,
                    tri_uv=None, want_uv=False, tri_tang=None):
    """The nearest hit over every geom (and the mesh triangles, if any):
    a dict of per-ray fields ``dist`` (N,), ``hit`` (N,) bool,
    ``point``/``normal`` (N,3), ``geom_idx`` (N,) int64 and ``outside``
    (N,) bool, with ``uv`` (N,2) if ``want_uv`` and ``tang`` (N,6), the
    winner triangle's UV-chart gradients, if ``tri_tang`` (T,6) is given.
    A miss keeps dist NO_HIT and geom_idx 0.

    A running minimum over the geoms in order (their types are static),
    every temporary (N,3) or (N,); the strict ``<`` keeps the first geom
    on a tie, as the reference's argmin order does.  A moving geom
    (``velocity`` (G,3), ``time`` (N,)) is hit by shifting the ray back
    in time and the hit point forward."""
    n = origins.shape[0]
    zeros = origins.new_zeros
    best = dict(dist=torch.full((n,), NO_HIT, dtype=origins.dtype,
                                device=origins.device),
                point=zeros((n, 3)), normal=zeros((n, 3)),
                outside=torch.zeros((n,), dtype=torch.bool,
                                    device=origins.device),
                geom_idx=torch.zeros((n,), dtype=torch.int64,
                                     device=origins.device))
    if want_uv:
        best["uv"] = zeros((n, 2))
    if tri_tang is not None:
        # zeros on primitive winners: their charts are analytic
        best["tang"] = zeros((n, 6))

    def fold(d, p, nr, o, g, uv=None, tang=None):
        better = d < best["dist"]
        b3 = better[:, None]
        best["dist"] = torch.where(better, d, best["dist"])
        best["point"] = torch.where(b3, p, best["point"])
        best["normal"] = torch.where(b3, nr, best["normal"])
        best["outside"] = torch.where(better, o, best["outside"])
        best["geom_idx"] = torch.where(better, g, best["geom_idx"])
        if want_uv:
            best["uv"] = torch.where(b3, uv if uv is not None
                                     else zeros((n, 2)), best["uv"])
        if tri_tang is not None:
            best["tang"] = torch.where(b3, tang if tang is not None
                                       else zeros((n, 6)), best["tang"])

    for g, kind in enumerate(int(k) for k in geom_type):
        if kind == T.MESH:
            continue  # a mesh's placeholder geom is hit through its triangles
        o_g = origins
        if velocity is not None:
            o_g = origins - time[:, None] * velocity[g][None]
        if kind == T.SPHERE:
            res = _one_sphere(o_g, dirs, fwd[g], inv[g], inv_t[g], want_uv)
        else:
            res = _one_box(o_g, dirs, fwd[g], inv[g], want_uv)
        p = res[1]
        if velocity is not None:
            p = p + time[:, None] * velocity[g][None]
        fold(res[0], p, res[2], res[3], g, res[4] if want_uv else None)

    if tri_verts is not None and tri_verts.shape[0] > 0:
        _fold_triangles(fold, origins, dirs, tri_verts, tri_geom, fwd, inv,
                        inv_t, velocity, time, tri_uv, want_uv, tri_tang)
    best["hit"] = best["dist"] < NO_HIT
    return best


def triangle_uv_gradients(tri_verts, tri_uv):
    """Per-triangle object-space gradients of the UV chart: (grad_u
    (T,3), grad_v (T,3)) float32.  On a triangle (u, v) are affine in
    position, so ``g_u`` is the in-plane vector with ``g_u . e1 = du1``
    and ``g_u . e2 = du2``, solved through the 2x2 Gram system of the
    edges.  A zero-area face or a zero UV area gives zero gradients (the
    BUMPTEX tilt is then off there, never NaN).  A tensor input keeps its
    device; any other is read into a CPU tensor."""
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


def _f32(x):
    """``x`` as a float32 tensor: a tensor on its own device (its graph
    kept), anything else on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return vm.as_f32(x)
