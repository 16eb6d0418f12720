"""The scene tables packed one element at a time: the oracle of the
batched packing in ``pathtrace_tpu_torch/ops/cuda/megakernel.py``.

``pack_scene`` and ``pack_lights`` here build ``cam``, ``mats``, ``gmat``
and ``lights`` on the CPU with the per-element selects, stacks and slice
assignments of the reference's ``_pack_scene``/``_pack_lights`` (each
3x3 product entry a separate mul-add, each cube face a loop step, each
light row filled in place), so the batched packing has to give the same
bits and, through autograd, the same gradients.  Imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtrace_tpu_torch.core import types as T
from pathtrace_tpu_torch.core.constants import PI, TRANSMISSION_PUSH
from pathtrace_tpu_torch.core.vecmath import as_f32 as _f32

LIGHT_COLS = 128


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
    return torch.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)],
        dim=-1,
    )


def mat3_mat(a, b):
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


def rotation(rotation_deg):
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
    rs = rotation(rotation_deg) * scale[..., None, :]
    return _homogeneous(torch.cat([rs, translation[..., :, None]], dim=-1))


def trs_inverse(translation, rotation_deg, scale, eps=1e-12):
    rt = rotation(rotation_deg).transpose(-1, -2)
    inv_s = 1.0 / (scale + torch.where(scale >= 0, eps, -eps))
    lin = rt * inv_s[..., :, None]
    trans = -mat3_vec(lin, translation)
    return _homogeneous(torch.cat([lin, trans[..., :, None]], dim=-1))


def geom_transforms(geoms):
    t, r, s = (_f32(geoms.translation), _f32(geoms.rotation),
               _f32(geoms.scale))
    fwd = trs_matrix(t, r, s)
    inv = trs_inverse(t, r, s)
    return fwd, inv, inv.transpose(-1, -2)


def camera_basis(camera, width, height):
    view = normalize(_f32(camera.view))
    right = normalize(cross(view, _f32(camera.up)))
    up = normalize(cross(right, view))
    tan_y = torch.tan(_f32(camera.fovy_deg) * (PI / 180.0))
    tan_x = tan_y * (width / height)
    return view, right, up, tan_x, tan_y


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _sum3(v):
    return v[0] + v[1] + v[2]


def cube_light_tables(fwd_g):
    cols = [fwd_g[:3, j] for j in range(3)]
    trans = fwd_g[:3, 3]
    origins, e_bs, e_cs, normals, areas = [], [], [], [], []
    for axis in range(3):
        b, c = (axis + 1) % 3, (axis + 2) % 3
        cr = _cross(cols[b], cols[c])
        area = torch.sqrt(_sum3(cr * cr))
        for sign in (1.0, -1.0):
            center = trans + cols[axis] * (0.5 * sign)
            orient = _sum3(cr * cols[axis])
            n = cr * (torch.where(orient >= 0, 1.0, -1.0) * sign)
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
    c0, c1, c2 = (fwd_g[:3, j] for j in range(3))
    return torch.abs(_sum3(c0 * _cross(c1, c2)))


def pack_scene(scene):
    """(cam (1,16), mats (G,24), gmat (G,40)) on the CPU."""
    width, height = scene.resolution
    view, right, up, tan_x, tan_y = camera_basis(scene.camera, width, height)
    cam = torch.cat([
        _f32(scene.camera.position).reshape(-1), view, right, up,
        torch.stack([tan_x, tan_y, _f32(scene.camera.aperture),
                     _f32(scene.camera.focal_dist)]),
    ]).reshape(1, 16)

    m = scene.materials
    mid = torch.as_tensor(np.asarray(scene.geoms.material_id),
                          dtype=torch.int64)
    n_m = m.count

    def opt(x, shape, fill):
        return _f32(x) if x is not None else torch.full(shape, fill)

    def col(x):
        return _f32(x)[mid][:, None]

    mats = torch.cat([
        _f32(m.color)[mid], _f32(m.spec_color)[mid],
        col(m.spec_exponent), col(m.has_reflective), col(m.has_refractive),
        col(m.ior), col(m.emittance),
        opt(m.checker_scale, (n_m,), 0.0)[mid][:, None],
        opt(m.checker_color, (n_m, 3), 0.0)[mid],
        opt(m.bump_scale, (n_m,), 0.0)[mid][:, None],
        opt(m.bump_strength, (n_m,), 0.0)[mid][:, None],
        opt(m.sss_sigma, (n_m,), 0.0)[mid][:, None],
        opt(m.sss_albedo, (n_m, 3), 1.0)[mid],
        opt(m.bumptex_strength, (n_m,), 0.0)[mid][:, None],
        torch.zeros((mid.shape[0], 2)),
    ], dim=1)

    fwd, inv, inv_t = geom_transforms(scene.geoms)
    n_g = fwd.shape[0]
    vel = scene.geoms.velocity
    vel = _f32(vel) if vel is not None else torch.zeros((n_g, 3))
    push = TRANSMISSION_PUSH * torch.amax(
        torch.abs(_f32(scene.geoms.scale)), dim=-1)[:, None]
    gmat = torch.cat([
        fwd[:, :3, :].reshape(-1, 12),
        inv[:, :3, :].reshape(-1, 12),
        inv_t[:, :3, :3].reshape(-1, 9),
        vel, push, torch.zeros((n_g, 3)),
    ], dim=1)
    return cam, mats, gmat


def pack_lights(scene):
    """(lights (L,128), ((geom index, type), ...)) on the CPU, or (None,
    ()) for a scene with no emissive geom."""
    if not scene.light_indices:
        return None, ()
    fwd, _, inv_t = geom_transforms(scene.geoms)
    m = scene.materials
    color, emittance = _f32(m.color), _f32(m.emittance)
    rows, statics = [], []
    for li in scene.light_indices:
        ltype = int(scene.geoms.type[li])
        statics.append((int(li), ltype))
        mid = int(scene.geoms.material_id[li])
        row = torch.zeros(LIGHT_COLS)
        row[0], row[1] = float(li), float(ltype)
        row[2:5] = color[mid] * emittance[mid]
        if ltype == T.SPHERE:
            row[12:21] = fwd[li][:3, :3].reshape(-1)
            row[21:24] = fwd[li][:3, 3]
            row[24:33] = inv_t[li][:3, :3].reshape(-1)
            row[33] = sphere_det3(fwd[li])
        else:
            tab = cube_light_tables(fwd[li])
            area = tab["area"]
            total = area[0]
            for a in area[1:]:
                total = total + a
            row[5] = total
            row[6:12] = torch.cumsum(area, 0) / torch.clamp_min(total, 1e-20)
            row[12:30] = tab["origin"].reshape(-1)
            row[30:48] = tab["e_b"].reshape(-1)
            row[48:66] = tab["e_c"].reshape(-1)
            row[66:84] = tab["normal"].reshape(-1)
        if scene.geoms.velocity is not None:
            row[120:123] = _f32(scene.geoms.velocity)[li]
        rows.append(row)
    return torch.stack(rows), tuple(statics)
