"""Forward path-trace megakernel (K1, with NEE: K2, with meshes: K3):
host side, plain version, wrapper.

Counterpart of ``pathtrace_tpu/ops/pallas/megakernel.py`` for the
forward render path: ``pack_scene``, ``pack_lights`` and ``pack_mesh``
build the same ``cam``/``mats``/``gmat``/``lights``/``tri``/``nodes``
tables as ``_pack_scene`` and ``_pack_lights``; ``trace_k1`` launches
the CUDA kernel
``csrc/megakernel.cu`` (which replaces the Pallas ``_kernel``), built
once per feature set as Mosaic specializes the reference's; and
``trace_plain`` is the same computation in plain PyTorch, one element per
pixel, following the kernel's own math and operation order (not the
wavefront integrator's).

Every scene without image textures renders here: spheres, cubes and
triangle meshes (one skip-link BVH walk per ray and MESH geom); diffuse,
mirror, imperfect-specular, glass, emissive and subsurface materials;
depth of field, motion blur, checker and bump; NEE and Russian roulette.
Image textures raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import numpy as np
import torch

from ...core import rng
from ...core import types as T
from ...core.constants import (
    NO_HIT, PI, RAY_OFFSET, SQRT_OF_ONE_THIRD, TRANSMISSION_PUSH, TWO_PI,
)
from ...core.rng import Draw
from ...core.vecmath import as_f32 as _f32
from ...render.integrator import camera_basis, geom_transforms
from .. import lights as L

# Launches of the CUDA kernel (``trace_k1`` on a CUDA device) by feature
# mask (``feature_mask``), so a run can show which builds it went through.
LAUNCHES = Counter()

FEATURE_NAMES = ("glass", "imperfect specular", "depth of field",
                 "motion blur", "checker", "bump", "subsurface scattering")
NO_FEATURES = (False,) * len(FEATURE_NAMES)
# bits of the kernel's compile-time feature mask past the scene features
NEE_BIT = 1 << len(FEATURE_NAMES)
RR_BIT = NEE_BIT << 1
MESH_BIT = RR_BIT << 1
LIGHT_COLS = 128
TRI_COLS = 16  # v0 (3), e1 (3), e2 (3), object-space unit normal (3), pad
_TEX_TODO = "ROADMAP Queue 1 item 8 (image textures, kernel K4)"


def _c32(x):
    """A Python float holding float32(x): the constant the reference
    rounds to f32 before it meets a plane."""
    return float(np.float32(x))


def scene_features(scene):
    """(has_glass, has_imperfect, has_dof, has_motion, has_checker,
    has_bump, has_sss): the static scene facts the reference specializes
    its kernel on (``_scene_features``)."""
    m = scene.materials
    return (
        bool(np.any(np.asarray(m.has_refractive) > 0)),
        bool(np.any(np.asarray(m.spec_exponent) > 0)),
        bool(np.asarray(scene.camera.aperture) > 0),
        scene.geoms.velocity is not None,
        m.checker_scale is not None,
        m.bump_strength is not None,
        m.sss_sigma is not None,
    )


def feature_mask(features, nee, rr, mesh=False):
    """The kernel's compile-time feature set as an int: bit i for
    ``FEATURE_NAMES[i]``, then ``NEE_BIT``, ``RR_BIT`` and ``MESH_BIT``
    (the scene has a MESH geom)."""
    mask = sum(1 << i for i, on in enumerate(features) if on)
    return (mask | (NEE_BIT if nee else 0) | (RR_BIT if rr else 0)
            | (MESH_BIT if mesh else 0))


def scene_mask(scene, nee=False, rr=False):
    """``feature_mask`` of ``scene`` rendered with these options."""
    return feature_mask(scene_features(scene), nee, rr,
                        any(t == T.MESH for t in scene.geoms.type))


def check_supported(scene):
    """Raise ``NotImplementedError`` for what the kernel does not port
    yet: image textures."""
    if scene.textures or any(i >= 0 for i in scene.texture_ids) or any(
            i >= 0 for i in scene.bump_texture_ids) or (
            scene.materials.bumptex_strength is not None):
        raise NotImplementedError(
            f"image textures are not ported yet: {_TEX_TODO}")


def pack_scene(scene, device="cpu"):
    """Scene -> (cam (1,16), mats (G,24), gmat (G,40)) float32 tensors on
    ``device``, in the layouts of the reference's ``_pack_scene``:

    * cam: pos(3) view(3) right(3) up(3) tan_x tan_y aperture focal;
    * mats: the material row of each geom — color(3) spec_color(3)
      spec_ex refl refr ior emit | checker scale+color (11..14) | bump
      scale+strength (15..16) | SSS sigma+albedo (17..20) | BUMPTEX
      strength (21) | pad;
    * gmat: forward 3x4 (0..11), inverse 3x4 (12..23), invT 3x3
      (24..32), velocity (33..35), transmission push (36), pad.

    Computed on the CPU in float32 and then moved, so every device
    gets the same bits.
    """
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
        opt(m.checker_scale, (n_m,), 0.0)[mid][:, None],     # 11
        opt(m.checker_color, (n_m, 3), 0.0)[mid],            # 12..14
        opt(m.bump_scale, (n_m,), 0.0)[mid][:, None],        # 15
        opt(m.bump_strength, (n_m,), 0.0)[mid][:, None],     # 16
        opt(m.sss_sigma, (n_m,), 0.0)[mid][:, None],         # 17
        opt(m.sss_albedo, (n_m, 3), 1.0)[mid],               # 18..20
        opt(m.bumptex_strength, (n_m,), 0.0)[mid][:, None],  # 21
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
    return cam.to(device), mats.to(device), gmat.to(device)


def pack_lights(scene, device="cpu"):
    """The NEE light table of the reference's ``_pack_lights``: (lights
    (L,128) float32 on ``device``, ((geom index, type), ...) per light),
    or (None, ()) for a scene with no emissive geom, which NEE then
    renders plain.  Row layout: 0 geom index | 1 type | 2-4 emission |
    cube: 5 total area, 6-11 area cdf, 12-29 face origins, 30-47 e_b,
    48-65 e_c, 66-83 outward normals | sphere: 12-20 forward 3x3, 21-23
    center, 24-32 invT 3x3, 33 |det M3| | 120-122 velocity.  Computed on
    the CPU in float32, as ``pack_scene``."""
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
            row[33] = L.sphere_det3(fwd[li])
        else:
            tab = L.cube_light_tables(fwd[li])
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
    return torch.stack(rows).to(device), tuple(statics)


def pack_mesh(scene, device="cpu"):
    """The triangle tables of the reference's ``_pack_scene`` (its BVH
    branch): (tri (T,16), nodes (N,16)) float32 tensors on ``device``
    and the static ``bvh_meta``, or (None, None, ()) for a scene with no
    triangles.

    * tri: one row per triangle in BVH (leaf-contiguous) order: v0 (3),
      e1 = v1 - v0 (3), e2 = v2 - v0 (3), the object-space unit normal
      cross(e1, e2) / max(|.|, 1e-20) (3), zeros (4);
    * nodes: ``scene.mesh.bvh_nodes`` (``scene/bvh.py``: aabb min and
      max, skip link, leaf start and count, as float32);
    * bvh_meta: ((geom, node_off, n_nodes, tri_off, n_tris), ...), one
      entry per MESH geom that owns triangles.

    Computed on the CPU in float32, as ``pack_scene``; the norm is the
    square root of the sum of squares, rounded once (through float64).
    """
    mesh = scene.mesh
    if not mesh.count:
        return None, None, ()
    if not mesh.bvh_meta:
        raise ValueError("the mesh has no BVH: build it with "
                         "scene.bvh.with_bvh (load_scene does)")
    order = torch.as_tensor(np.asarray(mesh.bvh_order), dtype=torch.int64)
    tv = _f32(mesh.tri_verts)[order]
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    norm = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    norm = torch.sqrt(norm.double()).float()[:, None]
    n = n / torch.clamp_min(norm, 1e-20)
    tri = torch.cat([v0, e1, e2, n, torch.zeros((tv.shape[0], 4))], dim=1)
    meta = tuple(tuple(int(x) for x in e) for e in mesh.bvh_meta)
    return tri.to(device), _f32(mesh.bvh_nodes).to(device), meta


# ----------------------------------------------------------------------------
# plain PyTorch version of K1/K2/K3, on flat (N,) tensors
# ----------------------------------------------------------------------------

def _normalize3(x, y, z):
    # x * (1/sqrt(x.x)), never rsqrt: the reference's rounding
    inv = torch.reciprocal(torch.sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


def _div(a, t):
    """float32(a) / t as an IEEE division: PyTorch computes
    ``scalar / tensor`` as a reciprocal times the scalar."""
    return torch.full_like(t, a) / t


def _object_ray(m, ox, oy, oz, dx, dy, dz, time):
    """The ray in the object space of the geom whose gmat row is ``m``:
    (gox, goy, goz) the world origin moved back by ``time`` * velocity
    (motion blur; None: no motion), then (rox, roy, roz, rdx, rdy, rdz)
    with a unit direction."""
    if time is not None:
        gox, goy, goz = ox - time * m[33], oy - time * m[34], \
            oz - time * m[35]
    else:
        gox, goy, goz = ox, oy, oz
    # object-space ray (explicit mul-adds)
    rox = m[12] * gox + m[13] * goy + m[14] * goz + m[15]
    roy = m[16] * gox + m[17] * goy + m[18] * goz + m[19]
    roz = m[20] * gox + m[21] * goy + m[22] * goz + m[23]
    rdx = m[12] * dx + m[13] * dy + m[14] * dz
    rdy = m[16] * dx + m[17] * dy + m[18] * dz
    rdz = m[20] * dx + m[21] * dy + m[22] * dz
    return (gox, goy, goz), (rox, roy, roz, *_normalize3(rdx, rdy, rdz))


def _slab(mn, mx, o, ird):
    """One axis of a ray/box slab test: (t entering, t leaving).  A NaN
    (origin on the slab plane, zero direction component) frees the
    axis: -inf / +inf."""
    t1 = (mn - o) * ird
    t2 = (mx - o) * ird
    ta = torch.minimum(t1, t2)  # propagates a NaN, as the reference's
    tb = torch.maximum(t1, t2)
    return (torch.where(torch.isnan(ta), -float("inf"), ta),
            torch.where(torch.isnan(tb), float("inf"), tb))


def _moller_trumbore(ray, row):
    """Ray (rox, roy, roz, rdx, rdy, rdz) against the triangles of
    ``row`` (N,16) (``pack_mesh`` layout): (tt, hit)."""
    rox, roy, roz, rdx, rdy, rdz = ray[:6]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:, :9].unbind(1)
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    ok = torch.abs(det) > 1e-12
    inv_det = torch.reciprocal(torch.where(ok, det, 1.0))
    tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return tt, ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (tt > 0.0)


def _mesh_walk(ray, t0, want, nodes, tri, tri_off):
    """K3's traversal, per ray: each ray in ``want`` walks the skip-link
    BVH ``nodes`` (one geom's (n,16) table) from node 0 with its own
    cursor, entering a node whose box it meets before ``t_loc`` (``t0``
    at first) and skipping it otherwise; in a leaf it tests the leaf's
    triangles in row order, each hit nearer than ``t_loc`` becoming the
    winner (so the first of two equal distances wins, as in the
    reference's DFS order).  ``ray`` is (rox, roy, roz, rdx, rdy, rdz,
    1/rdx, 1/rdy, 1/rdz) in the geom's object space; leaf starts count
    from row ``tri_off`` of ``tri``.  The rays still walking are kept
    compacted, one step per loop.  Returns the winner's row in ``tri``
    per ray (int64, -1: none)."""
    widx = torch.full_like(t0, -1, dtype=torch.int64)
    live = torch.nonzero(want).squeeze(1)
    rays = torch.stack(ray, dim=1)[live]
    t_loc = t0[live]
    win = torch.full_like(live, -1)
    cur = torch.zeros_like(live)
    n_nodes = nodes.shape[0]
    while live.numel():
        node = nodes[cur]
        tax, tbx = _slab(node[:, 0], node[:, 3], rays[:, 0], rays[:, 6])
        tay, tby = _slab(node[:, 1], node[:, 4], rays[:, 1], rays[:, 7])
        taz, tbz = _slab(node[:, 2], node[:, 5], rays[:, 2], rays[:, 8])
        tnear = torch.maximum(torch.maximum(tax, tay),
                              torch.clamp_min(taz, 0.0))
        tfar = torch.minimum(torch.minimum(tbx, tby), tbz)
        box_hit = (tnear <= tfar) & (tnear < t_loc)
        # float-coded integers, truncated as the reference's astype
        skip, start, count = node[:, 6:9].to(torch.int64).unbind(1)
        is_leaf = count > 0
        leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if leaf.numel():
            first = tri_off + start[leaf]
            cnt = count[leaf]
            lray = rays[leaf].unbind(1)
            lt, lw = t_loc[leaf], win[leaf]
            for k in range(int(cnt.max())):
                row = torch.where(k < cnt, first + k, first)
                tt, hit = _moller_trumbore(lray, tri[row])
                upd = (k < cnt) & hit & (tt < lt)
                lt = torch.where(upd, tt, lt)
                lw = torch.where(upd, row, lw)
            t_loc[leaf], win[leaf] = lt, lw
        cur = torch.where(is_leaf | ~box_hit, skip, cur + 1)
        done = cur >= n_nodes
        if bool(done.any()):
            widx[live[done]] = win[done]
            keep = ~done
            live, rays, t_loc, win, cur = (
                live[keep], rays[keep], t_loc[keep], win[keep], cur[keep])
    return widx


def _nearest(ox, oy, oz, dx, dy, dz, time, gmat, geom_types, shadow=False,
             mesh=None, want=None):
    """Nearest hit over the geoms by world-space distance, the winner
    kept on a strict ``dist < best`` (ties keep the geom folded first):
    the spheres and cubes in index order, then each MESH geom of
    ``mesh`` = (tri, nodes, bvh_meta) in ``bvh_meta`` order (a BVH walk,
    :func:`_mesh_walk`, then one fold of its winning triangle).
    ``gmat`` is a list of rows of Python floats; ``time`` is the shutter
    time (motion blur) or None; ``want`` (bool, optional) marks the rays
    whose result is read: only they walk the meshes.  Returns the
    winner's ``dist``, ``geom`` (int64, -1 on a miss) and ``hit``;
    unless ``shadow``, also its world point ``p*``, normal ``n*``
    (before bump), object-space point ``q*`` and ``outside``.  The shadow
    form skips the normals; its distances and winners are those of the
    full fold."""
    zeros = torch.zeros_like(ox)
    h = SimpleNamespace(dist=torch.full_like(ox, NO_HIT),
                        geom=torch.full_like(ox, -1, dtype=torch.int64))
    if not shadow:
        h.px, h.py, h.pz = ox, oy, oz
        h.nx = h.ny = h.nz = h.qx = h.qy = h.qz = zeros
        h.outside = torch.zeros_like(ox, dtype=torch.bool)

    def fold(g, m, hit, q, go, n0=None, out0=None):
        """World point and distance of the candidate hits (object-space
        point ``q``), folded into ``h`` where nearer."""
        qx, qy, qz = q
        pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3]
        pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7]
        pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11]
        ddx, ddy, ddz = go[0] - pxw, go[1] - pyw, go[2] - pzw
        if time is not None:
            # the hit point back at shutter time t, on the moved object
            pxw = pxw + time * m[33]
            pyw = pyw + time * m[34]
            pzw = pzw + time * m[35]
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        dist = torch.where(hit, dist, NO_HIT)
        better = dist < h.dist
        h.dist = torch.where(better, dist, h.dist)
        h.geom = torch.where(better, g, h.geom)
        if shadow:
            return

        def sel(a, b):
            return torch.where(better, a, b)

        h.px, h.py, h.pz = sel(pxw, h.px), sel(pyw, h.py), sel(pzw, h.pz)
        h.nx, h.ny, h.nz = sel(n0[0], h.nx), sel(n0[1], h.ny), \
            sel(n0[2], h.nz)
        h.qx, h.qy, h.qz = sel(qx, h.qx), sel(qy, h.qy), sel(qz, h.qz)
        h.outside = sel(out0, h.outside)

    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            continue  # folded after the primitives, by bvh_meta
        m = gmat[g]
        go, (rox, roy, roz, rdx, rdy, rdz) = _object_ray(
            m, ox, oy, oz, dx, dy, dz, time)
        n0 = out0 = None
        if gtype == T.SPHERE:
            # radius 0.5 is implicit: r^2 = 0.25
            vdd = rox * rdx + roy * rdy + roz * rdz
            rad2 = vdd * vdd - (rox * rox + roy * roy + roz * roz - 0.25)
            has_root = rad2 >= 0
            sq = torch.sqrt(torch.where(has_root, rad2, 1.0))
            t1 = -vdd + sq
            t2 = -vdd - sq
            both_neg = (t1 < 0) & (t2 < 0)
            both_pos = (t1 > 0) & (t2 > 0)
            t_use = torch.where(both_pos, torch.minimum(t1, t2),
                                torch.maximum(t1, t2))
            hit = has_root & ~both_neg
            tofs = t_use - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz
            if not shadow:
                # normal via invT (24..32), flipped inside
                nx0 = m[24] * qx + m[25] * qy + m[26] * qz
                ny0 = m[27] * qx + m[28] * qy + m[29] * qz
                nz0 = m[30] * qx + m[31] * qy + m[32] * qz
                nx0, ny0, nz0 = _normalize3(nx0, ny0, nz0)
                flip = torch.where(both_pos, 1.0, -1.0)
                n0 = (nx0 * flip, ny0 * flip, nz0 * flip)
                out0 = both_pos
        else:  # CUBE: slab test, sequential-axis semantics
            tmin = torch.full_like(ox, -1e38)
            tmax = torch.full_like(ox, 1e38)
            nmin = [zeros] * 3
            nmax = [zeros] * 3
            nan_axis = torch.zeros_like(ox, dtype=torch.bool)
            for ax, (qo, qd) in enumerate(
                    [(rox, rdx), (roy, rdy), (roz, rdz)]):
                # qd may be 0: +-inf, and 0/0 = NaN marks a miss
                t1 = (-0.5 - qo) / qd
                t2 = (0.5 - qo) / qd
                ta = torch.minimum(t1, t2)
                tb = torch.maximum(t1, t2)
                nan_axis = nan_axis | torch.isnan(t1) | torch.isnan(t2)
                upd_min = (ta > 0) & (ta > tmin)
                tmin = torch.where(upd_min, ta, tmin)
                upd_max = tb < tmax
                tmax = torch.where(upd_max, tb, tmax)
                if not shadow:
                    sign = torch.where(t2 < t1, 1.0, -1.0)
                    nmin = [torch.where(upd_min, sign if k == ax else 0.0,
                                        nmin[k]) for k in range(3)]
                    nmax = [torch.where(upd_max, sign if k == ax else 0.0,
                                        nmax[k]) for k in range(3)]
            hit = (tmax >= tmin) & (tmax > 0) & ~nan_axis
            inside = tmin <= 0
            t_use = torch.where(inside, tmax, tmin)
            tofs = t_use - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz
            if not shadow:
                nox, noy, noz = (torch.where(inside, nmax[k], nmin[k])
                                 for k in range(3))
                # quirk: box normal via the FORWARD transform
                # (src/intersections.h:85)
                n0 = _normalize3(m[0] * nox + m[1] * noy + m[2] * noz,
                                 m[4] * nox + m[5] * noy + m[6] * noz,
                                 m[8] * nox + m[9] * noy + m[10] * noz)
                out0 = ~inside
        fold(g, m, hit, (qx, qy, qz), go, n0, out0)

    tri, nodes, bvh_meta = mesh if mesh is not None else (None, None, ())
    want = torch.ones_like(ox, dtype=torch.bool) if want is None else want
    for g, node_off, n_nodes, tri_off, _ in bvh_meta:
        m = gmat[g]
        go, ray = _object_ray(m, ox, oy, oz, dx, dy, dz, time)
        rox, roy, roz, rdx, rdy, rdz = ray
        # exact object-space pruning bound from the winner so far: dist =
        # (t - RAY_OFFSET) * |L rd| with L the linear part of the forward
        # transform, so t_bound = dist / |L rd| + RAY_OFFSET (+ slack)
        wdx = m[0] * rdx + m[1] * rdy + m[2] * rdz
        wdy = m[4] * rdx + m[5] * rdy + m[6] * rdz
        wdz = m[8] * rdx + m[9] * rdy + m[10] * rdz
        s_ray = torch.sqrt(wdx * wdx + wdy * wdy + wdz * wdz)
        t0 = (h.dist / torch.clamp_min(s_ray, 1e-20) * _c32(1.0 + 1e-5)
              + RAY_OFFSET + 1e-4)
        widx = _mesh_walk(
            (*ray, _div(1.0, rdx), _div(1.0, rdy), _div(1.0, rdz)), t0,
            want, nodes[node_off:node_off + n_nodes], tri, tri_off)
        # the shading fold, once, on the winning row (a zero row for none)
        row = _rows(tri, widx)
        tt, hit = _moller_trumbore(ray, row)
        hit = hit & (widx >= 0)
        tofs = tt - RAY_OFFSET
        qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz
        n0 = out0 = None
        if not shadow:
            # the ray-facing geometric normal through invT
            nox, noy, noz = row[:, 9], row[:, 10], row[:, 11]
            face = rdx * nox + rdy * noy + rdz * noz
            flip = torch.where(face < 0.0, 1.0, -1.0)
            n0 = _normalize3((m[24] * nox + m[25] * noy + m[26] * noz) * flip,
                             (m[27] * nox + m[28] * noy + m[29] * noz) * flip,
                             (m[30] * nox + m[31] * noy + m[32] * noz) * flip)
            out0 = hit & (face < 0.0)
        fold(g, m, hit, (qx, qy, qz), go, n0, out0)
    h.hit = h.dist < NO_HIT
    return h


def _rows(table, geom):
    """Each ray's row of ``table`` (G,C) by winning geom, (N,C); a miss
    (-1) gets the zero row, as the reference's fold leaves its planes."""
    pad = torch.zeros((1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad])[geom]


def _bump_perturb(nx, ny, nz, qx, qy, qz, bs, bk, t):
    """Procedural bump (BUMP extension): the shading normal tilted by
    the analytic gradient of h = sin(w qx) sin(w qy) sin(w qz), through
    the geom's inverse-transpose ``t`` (9 columns); ``bk`` > 0 only."""
    w = bs * _c32(TWO_PI)
    ph = 0.5  # phase: non-degenerate on cube faces
    sx, cx = torch.sin(w * qx + ph), torch.cos(w * qx + ph)
    sy, cy = torch.sin(w * qy + ph), torch.cos(w * qy + ph)
    sz, cz = torch.sin(w * qz + ph), torch.cos(w * qz + ph)
    gx_o = w * cx * sy * sz
    gy_o = w * sx * cy * sz
    gz_o = w * sx * sy * cz
    gx = t[0] * gx_o + t[1] * gy_o + t[2] * gz_o
    gy = t[3] * gx_o + t[4] * gy_o + t[5] * gz_o
    gz = t[6] * gx_o + t[7] * gy_o + t[8] * gz_o
    gdn = gx * nx + gy * ny + gz * nz
    tx = gx - gdn * nx
    ty = gy - gdn * ny
    tz = gz - gdn * nz
    px, py, pz = _normalize3(nx - bk * tx, ny - bk * ty, nz - bk * tz)
    on = bk > 0.0
    return (torch.where(on, px, nx), torch.where(on, py, ny),
            torch.where(on, pz, nz))


def _surface(h, mats, gmat, checker, bump):
    """The winner's material row (``row[:, k]``), albedo (checker) and
    shading normal (bump), computed after the fold from its object-space
    point: the arithmetic of the reference's per-geom fold on the same
    inputs."""
    row = _rows(mats, h.geom)
    albedo = [row[:, 0], row[:, 1], row[:, 2]]
    if checker:
        cs = row[:, 11]
        ph = 0.015625
        cells = (torch.floor(h.qx * cs - ph) + torch.floor(h.qy * cs - ph)
                 + torch.floor(h.qz * cs - ph))
        odd = (cs > 0.0) & (cells - 2.0 * torch.floor(cells * 0.5) >= 1.0)
        albedo = [torch.where(odd, row[:, 12 + k], albedo[k])
                  for k in range(3)]
    n = (h.nx, h.ny, h.nz)
    if bump:
        t = _rows(gmat, h.geom)[:, 24:33].unbind(1)
        n = _bump_perturb(*n, h.qx, h.qy, h.qz, row[:, 15], row[:, 16], t)
    return row, albedo, n


def _imperfect_specular(m_ex, mrx, mry, mrz, u_s1, u_s2):
    """Power-cosine sample about the mirror direction (GPU Gems 3
    ch. 20) where ``m_ex`` > 0; the mirror direction elsewhere."""
    s3 = _c32(SQRT_OF_ONE_THIRD)
    n1 = torch.reciprocal(m_ex + 1.0)
    cos_t = torch.pow(torch.clamp_min(u_s1, 1e-12), n1)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = u_s2 * _c32(TWO_PI)
    use_xm = torch.abs(mrx) < s3
    use_ym = ~use_xm & (torch.abs(mry) < s3)
    nmx = torch.where(use_xm, 1.0, 0.0)
    nmy = torch.where(use_ym, 1.0, 0.0)
    nmz = torch.where(use_xm | use_ym, 0.0, 1.0)
    q1x, q1y, q1z = _normalize3(mry * nmz - mrz * nmy, mrz * nmx - mrx * nmz,
                                mrx * nmy - mry * nmx)
    q2x, q2y, q2z = _normalize3(mry * q1z - mrz * q1y, mrz * q1x - mrx * q1z,
                                mrx * q1y - mry * q1x)
    cp, sp = torch.cos(phi), torch.sin(phi)
    imx = cos_t * mrx + cp * sin_t * q1x + sp * sin_t * q2x
    imy = cos_t * mry + cp * sin_t * q1y + sp * sin_t * q2y
    imz = cos_t * mrz + cp * sin_t * q1z + sp * sin_t * q2z
    use_imp = m_ex > 0.0
    return (torch.where(use_imp, imx, mrx), torch.where(use_imp, imy, mry),
            torch.where(use_imp, imz, mrz))


def _nee_add(rad, thr, h, n, albedo, has_diffuse, time, it, pix, dep,
             lights, gmat, geom_types, mesh):
    """Direct lighting at the hit points: per light one area sample and
    one shadow ray, added where ``has_diffuse`` and the light is seen,
    with weight albedo/pi (the reference's ``_nee_add``).  ``lights``
    is a list of table rows of Python floats.  A light that is not a
    sphere is sampled as a cube, as the reference does (an emissive
    mesh too)."""
    nx, ny, nz = n
    rad = list(rad)
    for k, lr in enumerate(lights):
        li, ltype = int(lr[0]), int(lr[1])
        base = Draw.NEE_BASE + 3 * k
        u_sel = rng.uniform(it, pix, dep, base + 0)
        u1 = rng.uniform(it, pix, dep, base + 1)
        u2 = rng.uniform(it, pix, dep, base + 2)
        if ltype == T.SPHERE:
            # uniform direction on the unit sphere -> forward transform
            z = 1.0 - 2.0 * u1
            r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
            phi = u2 * _c32(TWO_PI)
            wx, wy, wz = r * torch.cos(phi), r * torch.sin(phi), z
            hx, hy, hz = 0.5 * wx, 0.5 * wy, 0.5 * wz
            lpx = lr[12] * hx + lr[13] * hy + lr[14] * hz + lr[21]
            lpy = lr[15] * hx + lr[16] * hy + lr[17] * hz + lr[22]
            lpz = lr[18] * hx + lr[19] * hy + lr[20] * hz + lr[23]
            lnx = lr[24] * wx + lr[25] * wy + lr[26] * wz
            lny = lr[27] * wx + lr[28] * wy + lr[29] * wz
            lnz = lr[30] * wx + lr[31] * wy + lr[32] * wz
            # |M^-T w| before normalizing: the per-sample area Jacobian
            n_len = torch.sqrt(lnx * lnx + lny * lny + lnz * lnz)
            w_area = _c32(_c32(PI) * lr[33]) * n_len
            inv_nl = torch.reciprocal(n_len)
            lnx, lny, lnz = lnx * inv_nl, lny * inv_nl, lnz * inv_nl
        else:
            # cube: a face by the area cdf, then (s, t) on it
            ss = u1 - 0.5
            tt = u2 - 0.5
            zeros = torch.zeros_like(u1)
            lpx = lpy = lpz = lnx = lny = lnz = zeros
            prev = 0.0
            for f in range(6):
                hi = lr[6 + f]
                mface = (u_sel >= prev) & (u_sel < hi) if f < 5 \
                    else u_sel >= prev
                o, eb, ec, nn = 12 + 3 * f, 30 + 3 * f, 48 + 3 * f, 66 + 3 * f
                lpx = torch.where(mface, lr[o] + ss * lr[eb] + tt * lr[ec],
                                  lpx)
                lpy = torch.where(mface, lr[o + 1] + ss * lr[eb + 1]
                                  + tt * lr[ec + 1], lpy)
                lpz = torch.where(mface, lr[o + 2] + ss * lr[eb + 2]
                                  + tt * lr[ec + 2], lpz)
                lnx = torch.where(mface, lr[nn], lnx)
                lny = torch.where(mface, lr[nn + 1], lny)
                lnz = torch.where(mface, lr[nn + 2], lnz)
                prev = hi
            w_area = lr[5]  # exact total area
        if time is not None:
            # a moving light: the sample point at the ray's time
            lpx = lpx + time * lr[120]
            lpy = lpy + time * lr[121]
            lpz = lpz + time * lr[122]

        wlx, wly, wlz = lpx - h.px, lpy - h.py, lpz - h.pz
        r2 = wlx * wlx + wly * wly + wlz * wlz
        r2_safe = torch.clamp_min(r2, 1e-8)
        dist_l = torch.sqrt(torch.clamp_min(r2, 1e-12))
        inv_dl = torch.reciprocal(dist_l)
        sdx, sdy, sdz = wlx * inv_dl, wly * inv_dl, wlz * inv_dl
        sh = _nearest(h.px, h.py, h.pz, sdx, sdy, sdz, time, gmat,
                      geom_types, shadow=True, mesh=mesh, want=has_diffuse)
        tol = torch.clamp_min(5e-3 * dist_l, 1e-3)
        visible = sh.hit & (sh.geom == li) & (torch.abs(sh.dist - dist_l)
                                              < tol)
        cos_s = torch.clamp_min(nx * sdx + ny * sdy + nz * sdz, 0.0)
        cos_l = torch.clamp_min(-(lnx * sdx + lny * sdy + lnz * sdz), 0.0)
        gterm = cos_s * cos_l / r2_safe * w_area
        w_ok = has_diffuse & visible
        for c in range(3):
            # (1/pi) * emission is one f32 product, as XLA folds the
            # reference's two scalar factors
            e_pi = _c32(_c32(1.0 / PI) * lr[2 + c])
            rad[c] = rad[c] + torch.where(
                w_ok, thr[c] * albedo[c] * e_pi * gterm, 0.0)
    return rad


def _trace_sample(it, pix, fx, fy, cam, mats_t, gmat_t, gmat, lights,
                  geom_types, width, height, depth, features, rr_mode,
                  counts, mesh):
    """One sample of every pixel: raygen, then ``depth`` bounces.
    Returns the sample's radiance [r, g, b]; adds the live count
    entering each bounce into ``counts``.  Every section runs on every
    lane and selects, as the reference's planes do."""
    (has_glass, has_imperfect, has_dof, has_motion, has_checker, has_bump,
     has_sss) = features
    nee = lights is not None
    (pos_x, pos_y, pos_z, v_x, v_y, v_z, r_x, r_y, r_z,
     u_x, u_y, u_z, tan_x, tan_y, aperture, focal) = cam

    ujx = rng.uniform(it, pix, 0, Draw.AA_X)
    ujy = rng.uniform(it, pix, 0, Draw.AA_Y)
    sx = (fx + ujx) * _c32(2.0 / width) - 1.0
    sy = (fy + ujy) * _c32(2.0 / height) - 1.0
    dx = v_x - r_x * (tan_x * sx) - u_x * (tan_y * sy)
    dy = v_y - r_y * (tan_x * sx) - u_y * (tan_y * sy)
    dz = v_z - r_z * (tan_x * sx) - u_z * (tan_y * sy)
    dx, dy, dz = _normalize3(dx, dy, dz)
    ox = torch.full_like(dx, pos_x)
    oy = torch.full_like(dx, pos_y)
    oz = torch.full_like(dx, pos_z)
    if has_dof and aperture > 0.0:
        # thin lens: origin on the aperture, through the focal plane
        u1 = rng.uniform(it, pix, 0, Draw.DOF_U)
        u2 = rng.uniform(it, pix, 0, Draw.DOF_V)
        r_lens = aperture * torch.sqrt(u1)
        theta = u2 * _c32(TWO_PI)
        lc, ls = r_lens * torch.cos(theta), r_lens * torch.sin(theta)
        off_x = r_x * lc + u_x * ls
        off_y = r_y * lc + u_y * ls
        off_z = r_z * lc + u_z * ls
        cos_v = dx * v_x + dy * v_y + dz * v_z
        ft = _div(focal, torch.clamp_min(cos_v, 1e-6))
        pfx, pfy, pfz = ox + dx * ft, oy + dy * ft, oz + dz * ft
        ox, oy, oz = ox + off_x, oy + off_y, oz + off_z
        dx, dy, dz = _normalize3(pfx - ox, pfy - oy, pfz - oz)
    thr_acc = [torch.ones_like(dx) for _ in range(3)]
    rad = [torch.zeros_like(dx) for _ in range(3)]
    live = torch.ones_like(dx, dtype=torch.bool)
    emit_ok = torch.ones_like(live)
    time = rng.uniform(it, pix, 0, Draw.TIME) if has_motion else None
    med_s = torch.zeros_like(dx)
    med = [torch.ones_like(dx) for _ in range(3)]
    s3 = _c32(SQRT_OF_ONE_THIRD)

    for d in range(depth):
        counts[d] += live.sum()
        h = _nearest(ox, oy, oz, dx, dy, dz, time, gmat, geom_types,
                     mesh=mesh, want=live)
        row, albedo, (nx, ny, nz) = _surface(h, mats_t, gmat_t,
                                             has_checker, has_bump)
        emit = row[:, 10]
        emissive = emit > 0.0

        # emission ends the path; with NEE only after a non-diffuse
        # bounce (or from the camera), so light is not counted twice
        lit = live & h.hit & emissive
        if nee:
            lit = lit & emit_ok
        rad = [rad[c] + torch.where(lit, thr_acc[c] * albedo[c] * emit, 0.0)
               for c in range(3)]

        dep = d + 1
        u_lobe = rng.uniform(it, pix, dep, Draw.LOBE)
        u_d1 = rng.uniform(it, pix, dep, Draw.DIFF_U1)
        u_d2 = rng.uniform(it, pix, dep, Draw.DIFF_U2)

        # diffuse: cosine hemisphere with the Peter-Kutz frame
        up = torch.sqrt(u_d1)
        over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
        around = u_d2 * _c32(TWO_PI)
        use_x = torch.abs(nx) < s3
        use_y = ~use_x & (torch.abs(ny) < s3)
        nn_x = torch.where(use_x, 1.0, 0.0)
        nn_y = torch.where(use_y, 1.0, 0.0)
        nn_z = torch.where(use_x | use_y, 0.0, 1.0)
        p1x, p1y, p1z = _normalize3(ny * nn_z - nz * nn_y,
                                    nz * nn_x - nx * nn_z,
                                    nx * nn_y - ny * nn_x)
        p2x, p2y, p2z = _normalize3(ny * p1z - nz * p1y,
                                    nz * p1x - nx * p1z,
                                    nx * p1y - ny * p1x)
        ca, sa = torch.cos(around), torch.sin(around)
        ddf = (up * nx + ca * over * p1x + sa * over * p2x,
               up * ny + ca * over * p1y + sa * over * p2y,
               up * nz + ca * over * p1z + sa * over * p2z)

        # mirror, and the power-cosine lobe about it
        ndoti = nx * dx + ny * dy + nz * dz
        mr = (dx - 2.0 * ndoti * nx, dy - 2.0 * ndoti * ny,
              dz - 2.0 * ndoti * nz)
        sp = mr
        if has_imperfect:
            sp = _imperfect_specular(
                row[:, 6], *mr, rng.uniform(it, pix, dep, Draw.SPEC_U1),
                rng.uniform(it, pix, dep, Draw.SPEC_U2))

        # spec/diffuse lobe split
        p_spec = torch.clamp(row[:, 7], 0.0, 1.0)
        take_spec = u_lobe < p_spec
        p_safe = torch.clamp_min(
            torch.where(take_spec, p_spec, 1.0 - p_spec), 1e-8)
        ndir = [torch.where(take_spec, sp[k], ddf[k]) for k in range(3)]
        thr = [torch.where(take_spec, row[:, 3 + k], albedo[k]) / p_safe
               for k in range(3)]
        took_diffuse = ~take_spec

        if has_glass:
            # Fresnel glass: Schlick's choice between the mirror and the
            # Snell refraction (always the mirror under total internal
            # reflection); no division by the choice's probability
            u_fr = rng.uniform(it, pix, dep, Draw.FRESNEL)
            cos_i = torch.clamp(-ndoti, 0.0, 1.0)
            ior = row[:, 9]
            r0 = (1.0 - ior) / (1.0 + ior)
            r0 = r0 * r0
            mm = torch.clamp_min(1.0 - cos_i, 0.0)
            refl_p = r0 + (1.0 - r0) * mm * mm * mm * mm * mm
            eta = torch.where(h.outside,
                              torch.reciprocal(torch.clamp_min(ior, 1e-6)),
                              ior)
            kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
            k_ok = kk >= 0.0
            sqk = torch.sqrt(torch.where(k_ok, kk, 1.0))
            rf = [eta * dk - (eta * ndoti + sqk) * nk
                  for dk, nk in ((dx, nx), (dy, ny), (dz, nz))]
            choose_refl = (u_fr < refl_p) | ~k_ok
            is_glass = row[:, 8] > 0.0
            ndir = [torch.where(is_glass,
                                torch.where(choose_refl, mr[k], rf[k]),
                                ndir[k]) for k in range(3)]
            thr = [torch.where(is_glass,
                               torch.where(choose_refl, row[:, 3 + k],
                                           albedo[k]), thr[k])
                   for k in range(3)]
            took_diffuse = took_diffuse & ~is_glass
            took_refract = is_glass & ~choose_refl

        cont = live & h.hit & ~emissive
        scatter_inside = torch.zeros_like(cont)
        if has_sss:
            # inside a medium: an exponential free path; ending before
            # the surface, the ray scatters there
            in_med = med_s > 0.0
            u_step = rng.uniform(it, pix, dep, Draw.SSS_STEP)
            sss_step = -torch.log(torch.clamp_min(1.0 - u_step, 1e-7)) \
                / torch.clamp_min(med_s, 1e-8)
            scatter_inside = in_med & live & h.hit & (sss_step < h.dist)

        op = [h.px, h.py, h.pz]
        if has_glass:
            # refracted continuations start past the interface
            push = _rows(gmat_t, h.geom)[:, 36]
            op = [torch.where(took_refract, op[k] + push * ndir[k], op[k])
                  for k in range(3)]

        if nee:
            has_diffuse = cont & ~scatter_inside & ~(row[:, 8] > 0.0)
            rad = _nee_add(rad, thr_acc, h, (nx, ny, nz), albedo,
                           has_diffuse, time, it, pix, dep, lights, gmat,
                           geom_types, mesh)

        if has_sss:
            # isotropic scatter inside, attenuated by the medium albedo
            zi = 1.0 - 2.0 * rng.uniform(it, pix, dep, Draw.SSS_U)
            ri = torch.sqrt(torch.clamp_min(1.0 - zi * zi, 0.0))
            phi = rng.uniform(it, pix, dep, Draw.SSS_V) * _c32(TWO_PI)
            o = (ox, oy, oz)
            dd = (dx, dy, dz)
            op = [torch.where(scatter_inside, o[k] + sss_step * dd[k], op[k])
                  for k in range(3)]
            ndir = [torch.where(scatter_inside, v, ndir[k]) for k, v in
                    enumerate((ri * torch.cos(phi), ri * torch.sin(phi),
                               zi))]
            thr = [torch.where(scatter_inside, med[k], thr[k])
                   for k in range(3)]
            if has_glass:
                # the medium changes only at refractions: entering a
                # geom with sigma > 0 from outside, or leaving from inside
                at_surface = cont & ~scatter_inside & took_refract
                entering = at_surface & (row[:, 17] > 0.0) & h.outside
                exiting = at_surface & in_med & ~h.outside
                med_s = torch.where(entering, row[:, 17],
                                    torch.where(exiting, 0.0, med_s))
                med = [torch.where(entering, row[:, 18 + k],
                                   torch.where(exiting, 1.0, med[k]))
                       for k in range(3)]

        if rr_mode and d >= 3:
            # Russian roulette from bounce 3 on, after NEE: survive with
            # the post-bounce throughput's largest channel, boosted by 1/p
            nt = [thr_acc[k] * thr[k] for k in range(3)]
            p_srv = torch.clamp(torch.maximum(nt[0], torch.maximum(nt[1],
                                                                   nt[2])),
                                0.05, 1.0)
            survive = rng.uniform(it, pix, dep, Draw.RR) < p_srv
            cont = cont & survive
            boost = torch.where(survive, torch.reciprocal(p_srv), 1.0)
            thr = [t * boost for t in thr]

        # the state changes only where the path continues
        ox, oy, oz = (torch.where(cont, op[k], v)
                      for k, v in enumerate((ox, oy, oz)))
        dx, dy, dz = (torch.where(cont, ndir[k], v)
                      for k, v in enumerate((dx, dy, dz)))
        thr_acc = [torch.where(cont, thr_acc[k] * thr[k], thr_acc[k])
                   for k in range(3)]
        emit_ok = ~took_diffuse | scatter_inside
        live = cont
    return rad


def trace_plain(cam, mats, gmat, geom_types, width, height, depth, it0,
                n_spp, pix0=0, features=NO_FEATURES, lights=None, rr=False,
                tri=None, nodes=None, bvh_meta=()):
    """Plain PyTorch K1 on the device of ``cam``: ``n_spp`` samples of
    pixels ``pix0 ..`` to the end of the image (all of it by default) at
    iterations ``it0 .. it0+n_spp-1``, with the scene ``features``
    (``scene_features``), NEE over the ``lights`` table (``pack_lights``;
    None: no NEE), Russian roulette if ``rr`` and the triangle meshes of
    ``tri``, ``nodes`` and ``bvh_meta`` (``pack_mesh``).

    Returns (rad (P - pix0, 3) f32 summed over the samples, counts
    (depth,) int64: live paths entering each bounce, summed over the
    samples)."""
    device = cam.device
    cam_l = cam.reshape(-1).tolist()
    gmat_l = gmat.tolist()
    lights_l = lights.tolist() if lights is not None else None
    pixel = torch.arange(pix0, width * height, dtype=torch.int64,
                         device=device)
    fx = (pixel % width).to(torch.float32)
    fy = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    acc = [torch.zeros_like(fx) for _ in range(3)]
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    for s in range(n_spp):
        rad = _trace_sample(
            (it0 + s) & 0xFFFFFFFF, pixel, fx, fy, cam_l, mats, gmat,
            gmat_l, lights_l, tuple(geom_types), width, height, depth,
            tuple(features), rr, counts,
            (tri, nodes, tuple(bvh_meta)) if bvh_meta else None)
        acc = [a + r for a, r in zip(acc, rad)]
    return torch.stack(acc, dim=-1), counts


# ----------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ----------------------------------------------------------------------------

_INT_TABLES = {}


def _int_table(rows, device):
    """``rows`` (a static tuple: the geom types, ``bvh_meta``) as an
    int32 tensor on ``device``, made once."""
    key = (rows, str(device))
    if key not in _INT_TABLES:
        _INT_TABLES[key] = torch.tensor(rows, dtype=torch.int32,
                                        device=device).reshape(-1)
    return _INT_TABLES[key]


def _check_table(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous float32 {shape} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_mesh(tri, nodes, bvh_meta, geom_types, device):
    """The mesh tables must be ``pack_mesh``'s: every entry of
    ``bvh_meta`` a MESH geom whose rows lie inside ``nodes`` and ``tri``,
    its counts exact as float32."""
    if not bvh_meta:
        if tri is not None or nodes is not None:
            raise ValueError("mesh tables given without bvh_meta")
        return
    _check_table("tri", tri, (tri.shape[0], TRI_COLS), device)
    _check_table("nodes", nodes, (nodes.shape[0], 16), device)
    if tri.data_ptr() % 16 or nodes.data_ptr() % 16:
        raise ValueError("tri and nodes must be 16-byte aligned (the "
                         "kernel reads their rows as float4)")
    for g, node_off, n_nodes, tri_off, n_tris in bvh_meta:
        if not (0 <= g < len(geom_types) and geom_types[g] == T.MESH
                and 0 <= node_off and 0 < n_nodes <= 2 ** 24
                and node_off + n_nodes <= nodes.shape[0]
                and 0 <= tri_off and 0 < n_tris <= 2 ** 24
                and tri_off + n_tris <= tri.shape[0]):
            entry = (g, node_off, n_nodes, tri_off, n_tris)
            raise ValueError(f"bad bvh_meta entry {entry} for tables of "
                             f"{nodes.shape[0]} nodes, {tri.shape[0]} tris")


def trace_k1(cam, mats, gmat, geom_types, width, height, depth, it0, n_spp,
             pix0=0, features=NO_FEATURES, lights=None, rr=False,
             tri=None, nodes=None, bvh_meta=()):
    """K1 (and K2 when ``lights`` is given, K3 when ``bvh_meta`` is): the
    same computation and result as :func:`trace_plain`.

    For tensors on the CPU this is :func:`trace_plain`.  For tensors on
    a CUDA device it launches the kernel of ``csrc/megakernel.cu``
    compiled for this feature set on the current stream (building it at
    first use) and raises if the build or the launch fails."""
    device = cam.device
    if device.type == "cpu":
        return trace_plain(cam, mats, gmat, geom_types, width, height,
                           depth, it0, n_spp, pix0, features, lights, rr,
                           tri, nodes, bvh_meta)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {device}")
    from . import build

    geom_types, bvh_meta = tuple(geom_types), tuple(bvh_meta)
    n_geoms = len(geom_types)
    n_lights = 0 if lights is None else lights.shape[0]
    n_pixels = width * height
    n_local = n_pixels - pix0
    if any(t not in (T.SPHERE, T.CUBE, T.MESH) for t in geom_types):
        raise ValueError(f"unknown geom types in {geom_types}")
    if len(features) != len(FEATURE_NAMES) or not (
            0 < n_geoms and 0 < depth and 0 <= n_spp and 0 <= pix0
            and 0 < n_local and n_pixels < 2 ** 31
            and (lights is None or n_lights > 0)):
        raise ValueError(
            f"bad K1 sizes: {n_geoms} geoms, depth {depth}, {n_spp} spp, "
            f"pixels {pix0}+{n_local} of {n_pixels}, features {features}, "
            f"{n_lights} lights")
    _check_table("cam", cam, (1, 16), device)
    _check_table("mats", mats, (n_geoms, 24), device)
    _check_table("gmat", gmat, (n_geoms, 40), device)
    if lights is not None:
        _check_table("lights", lights, (n_lights, LIGHT_COLS), device)
    _check_mesh(tri, nodes, bvh_meta, geom_types, device)
    types = _int_table(geom_types, device)
    meta = _int_table(bvh_meta, device) if bvh_meta else None
    rad = torch.empty((n_local, 3), dtype=torch.float32, device=device)
    # the kernel adds into these as unsigned 64-bit integers
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    mask = feature_mask(features, lights is not None, rr, T.MESH in geom_types)
    lib = build.load_k1(mask)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_k1_trace(
            cam.data_ptr(), mats.data_ptr(), gmat.data_ptr(),
            types.data_ptr(), ptr(lights), ptr(tri), ptr(nodes), ptr(meta),
            n_geoms, n_lights, len(bvh_meta), width, height, depth,
            it0 & 0xFFFFFFFF, n_spp, pix0, n_local, rad.data_ptr(),
            counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: CUDA error {err} "
            f"({lib.pt_cuda_error_string(err).decode()})")
    LAUNCHES[mask] += 1
    return rad, counts


def prepare(scene, device="cuda", nee=False, rr=False):
    """Check that K1 can render ``scene`` on ``device`` and return the
    keyword arguments of :func:`trace_k1` (and :func:`trace_plain`) but
    ``it0`` and ``n_spp``: the packed tables on ``device``, resident for
    the whole render, and the static facts the kernel is compiled for.
    Raises ``NotImplementedError`` for what is not ported and
    ``RuntimeError`` for a CUDA device without a GPU."""
    check_supported(scene)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available")
    cam, mats, gmat = pack_scene(scene, device)
    lights = pack_lights(scene, device)[0] if nee else None
    tri, nodes, bvh_meta = pack_mesh(scene, device)
    width, height = scene.resolution
    return dict(cam=cam, mats=mats, gmat=gmat,
                geom_types=tuple(scene.geoms.type), width=width,
                height=height, depth=int(scene.trace_depth),
                features=scene_features(scene), lights=lights, rr=rr,
                tri=tri, nodes=nodes, bvh_meta=bvh_meta)


def pathtrace_batch_cuda(scene, it0, n_iters, device="cuda", nee=False,
                         rr=False):
    """``n_iters`` samples per pixel in one launch, mirroring the
    reference's ``pathtrace_batch_pallas``: returns (accumulated radiance
    (P,3) f32, counts (depth,) int64 summed over the samples) on
    ``device``.  A CPU device runs :func:`trace_plain`; a CUDA device
    runs the kernel and raises when there is no GPU."""
    return trace_k1(**prepare(scene, device, nee=nee, rr=rr), it0=it0,
                    n_spp=n_iters)
