"""The adjoint of the scene packing, written by hand: the gradients of the
packed tables (``megakernel.pack_scene``'s cam, mats and gmat,
``pack_lights``' light table) carried to the parameters of
``render/diff.split_params``.

It gives what ``torch.autograd.backward`` over the packing under autograd
gives, with no graph: ``vjp.render_vjp`` packs its tables plain and
chains K8's table gradients through :func:`pack_adjoint`.  The work is a
few hundred multiply-adds over a scene's geoms, so it is batched over
geoms and light rows in numpy, in float64 at the float32 parameters, and
rounded to float32 once at the end.  It agrees with the autograd chain
(float32 throughout) to rounding, not bit for bit
(``tests/test_torch_pack_adjoint.py`` holds it to that chain).

The chain, table by table:

* cam: through ``render/integrator.camera_basis`` (the normalised view,
  ``right = normalize(view x up)``, ``up' = normalize(right x view)``,
  ``tan_y = tan(fovy pi/180)``, ``tan_x = tan_y w/h``); position,
  aperture and focal distance pass straight through;
* mats: a scatter-add of columns 0-21 into the material fields through
  ``material_id``; an optional field that is off stays None;
* gmat: through ``core/vecmath.trs_affine`` (``R diag(s) | t`` and
  ``diag(1/(s +- eps)) R^T | -lin t``, R = Rx Ry Rz of the degrees; invT
  the inverse's linear part transposed) and the transmission push
  ``TRANSMISSION_PUSH max|s|``, whose gradient is sign(s) split evenly
  among tied maxima, as ``torch.amax`` splits it; the velocity is a
  constant;
* lights: the emission ``color[mid] emittance[mid]`` to the material; a
  cube through ``ops/lights.cube_light_tables`` (face origins, edges,
  outward normals, areas, their total and the cdf); a sphere through its
  forward 3x3, centre, invT and ``|det|``.  Both reach the TRS through
  the light's forward (and inverse) transform.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import vecmath as vm
from ...core.constants import PI, TRANSMISSION_PUSH
from ...core.types import SPHERE
from .. import lights as L

# the material fields and their columns of the mats table
MAT_COLS = (("color", slice(0, 3)), ("spec_color", slice(3, 6)),
            ("spec_exponent", 6), ("has_reflective", 7),
            ("has_refractive", 8), ("ior", 9), ("emittance", 10),
            ("checker_scale", 11), ("checker_color", slice(12, 15)),
            ("bump_scale", 15), ("bump_strength", 16), ("sss_sigma", 17),
            ("sss_albedo", slice(18, 21)), ("bumptex_strength", 21))
# a cube's faces as ops/lights.py orders them: each face's axis and its two
# edge axes as one-hot rows over the three columns, and its side
_FACE_A, _FACE_B, _FACE_C = (np.eye(3)[a.numpy()] for a in (
    L._FACE_AXIS, L._FACE_B, L._FACE_C))
_FACE_SIGN = L._FACE_SIGN.numpy().astype(np.float64)
# Rx, Ry, Rz entry by entry, as indices into their axis's (0, 1, cos, sin,
# -sin), as vecmath._rotation builds them
_ROT_ENTRIES = vm._ROT_ENTRIES.numpy()
_RAD = PI / 180.0
_EPS = 1e-12  # vecmath.trs_affine's


def _f64(x):
    """A float parameter as float64 numpy, holding its float32 value."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).astype(np.float64)


def _out(x, like):
    """``x`` as a float32 CPU tensor of the shape of the parameter
    ``like``."""
    return torch.from_numpy(np.asarray(x, np.float32).reshape(np.shape(like)))


def _dot(a, b):
    return (a * b).sum(-1, keepdims=True)


_NEXT, _LAST = np.array([1, 2, 0]), np.array([2, 0, 1])


def _cross(a, b):
    """a x b over the last axis (``np.cross`` takes six times as long)."""
    return (a.take(_NEXT, -1) * b.take(_LAST, -1)
            - a.take(_LAST, -1) * b.take(_NEXT, -1))


def _length(v):
    return np.sqrt(_dot(v, v))


def _normalize_adj(v, g):
    """The adjoint of ``v / |v|`` at ``v`` for the cotangent ``g``."""
    norm = _length(v)
    n = v / norm
    return (g - n * _dot(n, g)) / norm


def _camera(camera, d_cam, width, height):
    """The camera's gradients, {field: array}, from d_cam (16,)."""
    view_in, up_in = _f64(camera.view), _f64(camera.up)
    view = view_in / _length(view_in)
    right_raw = _cross(view, up_in)
    right = right_raw / _length(right_raw)
    up_raw = _cross(right, view)
    # a x b takes b x g to a and g x a to b
    g_up_raw = _normalize_adj(up_raw, d_cam[9:12])
    g_right = d_cam[6:9] + _cross(view, g_up_raw)
    g_view = d_cam[3:6] + _cross(g_up_raw, right)
    g_right_raw = _normalize_adj(right_raw, g_right)
    g_view = g_view + _cross(up_in, g_right_raw)
    tan_y = np.tan(_f64(camera.fovy_deg) * _RAD)
    g_tan_y = d_cam[13] + d_cam[12] * (width / height)
    return dict(position=d_cam[0:3], view=_normalize_adj(view_in, g_view),
                up=_cross(g_right_raw, view),
                fovy_deg=g_tan_y * (1.0 + tan_y * tan_y) * _RAD,
                aperture=d_cam[14], focal_dist=d_cam[15])


def _rotations(rot_deg):
    """(Rx, Ry, Rz) of the angles and their derivatives in radians,
    (G,3,3) each."""
    a = rot_deg * _RAD
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    # each axis's (0, 1, cos, sin, -sin), and their derivatives
    vals = np.stack([z, o, c, s, -s], axis=-1).reshape(-1, 15)
    dvals = np.stack([z, z, -s, c, -c], axis=-1).reshape(-1, 15)
    return (tuple(vals[:, _ROT_ENTRIES].transpose(1, 0, 2, 3)),
            tuple(dvals[:, _ROT_ENTRIES].transpose(1, 0, 2, 3)))


def _t(m):
    return np.swapaxes(m, -1, -2)


def _cube_lights(fwd_lin, d):
    """The adjoint of ``cube_light_tables`` and the cdf for cube light
    rows: ``fwd_lin`` (n,3,3) their forward linear parts, ``d`` (n,128)
    their rows' cotangents.  Returns (d fwd_lin (n,3,3), d translation
    (n,3))."""
    cols = _t(fwd_lin)  # the columns of each M as rows
    e_b = np.einsum("fk,nkj->nfj", _FACE_B, cols)
    e_c = np.einsum("fk,nkj->nfj", _FACE_C, cols)
    axis = np.einsum("fk,nkj->nfj", _FACE_A, cols)
    cr = _cross(e_b, e_c)
    area = _length(cr)[..., 0]
    total = np.sum(area, axis=-1)
    held = np.maximum(total, 1e-20)
    cum = np.cumsum(area, axis=-1)
    side = np.where(_dot(cr, axis)[..., 0] >= 0, 1.0, -1.0) * _FACE_SIGN
    n_raw = cr * side[..., None]
    g_cdf = d[:, 6:12]
    g_total = d[:, 5] - np.where(total >= 1e-20,
                                 np.sum(g_cdf * cum, axis=-1) / held ** 2, 0.0)
    g_cum = g_cdf / held[:, None]
    g_area = np.cumsum(g_cum[:, ::-1], axis=-1)[:, ::-1] + g_total[:, None]
    g_normal = d[:, 66:84].reshape(-1, 6, 3)
    g_cr = (g_area[..., None] * cr / area[..., None]
            + _normalize_adj(n_raw, g_normal) * side[..., None])
    g_origin = d[:, 12:30].reshape(-1, 6, 3)
    g_eb = d[:, 30:48].reshape(-1, 6, 3) + _cross(e_c, g_cr)
    g_ec = d[:, 48:66].reshape(-1, 6, 3) + _cross(g_cr, e_b)
    g_axis = g_origin * (0.5 * _FACE_SIGN)[:, None]
    g_cols = (np.einsum("fk,nfj->nkj", _FACE_B, g_eb)
              + np.einsum("fk,nfj->nkj", _FACE_C, g_ec)
              + np.einsum("fk,nfj->nkj", _FACE_A, g_axis))
    return _t(g_cols), np.sum(g_origin, axis=1)


def _sphere_det_adj(fwd_lin, g_det):
    """The adjoint of ``|det|`` of (n,3,3) matrices: sign(det) times the
    cofactors, (n,3,3)."""
    c0, c1, c2 = (fwd_lin[..., k] for k in range(3))
    det = np.sum(c0 * _cross(c1, c2), axis=-1)
    g = (g_det * np.sign(det))[:, None, None]
    return g * np.stack([_cross(c1, c2), _cross(c2, c0),
                         _cross(c0, c1)], axis=-1)


def pack_adjoint(scene, d_cam, d_mats, d_gmat, d_lights=None):
    """The gradients of the parameters of ``render/diff.split_params(
    scene)`` that the gradients of its packed tables give: ``d_cam``
    (1,16), ``d_mats`` (G,24), ``d_gmat`` (G,40) and, for a light table
    (NEE), ``d_lights`` (L,128), numpy arrays or tensors in the layouts
    of ``megakernel.pack_scene``/``pack_lights``.  Returns the gradients
    keyed as ``split_params``, float32 CPU tensors of the parameters'
    shapes: zeros where no table reads a parameter, None for an optional
    material field that is off, and for a mesh scene's ``tri_verts`` (the
    triangles are constants of the sweep)."""
    d_cam, d_mats, d_gmat = (_f64(x) for x in (d_cam, d_mats, d_gmat))
    width, height = scene.resolution
    geoms, m = scene.geoms, scene.materials
    n_g = len(geoms.type)

    # materials: a scatter-add through material_id, the emission of each
    # light row to its material's color and emittance
    mid = np.asarray(geoms.material_id, np.int64)
    g_mat = np.zeros((m.count, 22))
    np.add.at(g_mat, mid, d_mats[:, :22])

    t, s = _f64(geoms.translation), _f64(geoms.scale)
    (rx, ry, rz), (drx, dry, drz) = _rotations(_f64(geoms.rotation))
    rxy = rx @ ry
    rot = rxy @ rz
    fwd_lin = rot * s[:, None, :]
    g_fwd = d_gmat[:, :12].reshape(n_g, 3, 4).copy()
    g_inv = d_gmat[:, 12:24].reshape(n_g, 3, 4)
    g_inv_t = d_gmat[:, 24:33].reshape(n_g, 3, 3).copy()

    if d_lights is not None:
        d_lights = _f64(d_lights)
        li = np.asarray(scene.light_indices, np.int64)
        lm = mid[li]
        g_em = d_lights[:, 2:5]
        np.add.at(g_mat[:, 0:3], lm, g_em * _f64(m.emittance)[lm, None])
        np.add.at(g_mat[:, 10], lm, np.sum(g_em * _f64(m.color)[lm], -1))
        sphere = np.array([geoms.type[i] == SPHERE for i in li], bool)
        rows, gi = d_lights[sphere], li[sphere]
        g_fwd[gi, :, :3] += (rows[:, 12:21].reshape(-1, 3, 3)
                             + _sphere_det_adj(fwd_lin[gi], rows[:, 33]))
        g_fwd[gi, :, 3] += rows[:, 21:24]
        g_inv_t[gi] += rows[:, 24:33].reshape(-1, 3, 3)
        gi = li[~sphere]
        g_lin, g_tr = _cube_lights(fwd_lin[gi], d_lights[~sphere])
        g_fwd[gi, :, :3] += g_lin
        g_fwd[gi, :, 3] += g_tr

    # the TRS: forward R diag(s) | t, inverse lin = diag(inv_s) R^T and
    # -lin t, invT = lin^T
    inv_s = 1.0 / (s + np.where(s >= 0, _EPS, -_EPS))
    lin = _t(rot) * inv_s[:, :, None]
    g_lin = g_inv[:, :, :3] + _t(g_inv_t)
    g_trans = g_inv[:, :, 3]
    g_t = g_fwd[:, :, 3] - np.einsum("gij,gi->gj", lin, g_trans)
    g_lin = g_lin - g_trans[:, :, None] * t[:, None, :]
    g_rot = g_fwd[:, :, :3] * s[:, None, :] + _t(g_lin * inv_s[:, :, None])
    g_s = (np.einsum("gij,gij->gj", g_fwd[:, :, :3], rot)
           - np.einsum("gij,gji->gi", g_lin, rot) * inv_s * inv_s)
    # the push: sign(s) at the largest |s|, split evenly among ties
    mag = np.abs(s)
    top = mag == np.max(mag, axis=-1, keepdims=True)
    g_s = g_s + ((TRANSMISSION_PUSH * d_gmat[:, 36])[:, None] * np.sign(s)
                 * top / np.sum(top, axis=-1, keepdims=True))
    # R = (Rx Ry) Rz
    g_rz = _t(rxy) @ g_rot
    g_rxy = g_rot @ _t(rz)
    g_angles = np.stack([np.sum(g_rxy @ _t(ry) * drx, axis=(-2, -1)),
                         np.sum(_t(rx) @ g_rxy * dry, axis=(-2, -1)),
                         np.sum(g_rz * drz, axis=(-2, -1))], axis=-1)

    g_m = {}
    for name, col in MAT_COLS:
        leaf = getattr(m, name)
        g_m[name] = None if leaf is None else _out(g_mat[:, col], leaf)
    cam = _camera(scene.camera, d_cam[0], width, height)
    tri = scene.mesh.tri_verts
    return dict(
        materials=dataclasses.replace(m, **g_m),
        translation=_out(g_t, geoms.translation),
        rotation=_out(g_angles * _RAD, geoms.rotation),
        scale=_out(g_s, geoms.scale),
        camera=dataclasses.replace(scene.camera, **{
            k: _out(v, getattr(scene.camera, k)) for k, v in cam.items()}),
        tri_verts=None if scene.mesh.count else torch.zeros(np.shape(tri)))
