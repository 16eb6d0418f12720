"""Forward path-trace megakernel (K1): host side, plain version, wrapper.

Counterpart of ``pathtrace_tpu/ops/pallas/megakernel.py`` for the main
render path: ``pack_scene`` builds the same ``cam``/``mats``/``gmat``
tables as ``_pack_scene``; ``trace_k1`` launches the CUDA kernel
``csrc/megakernel.cu`` (which replaces the Pallas ``_kernel`` with every
feature section compiled out); ``trace_plain`` is the same computation
in plain PyTorch, one element per pixel, following the kernel's own
math and operation order (not the wavefront integrator's).

Only scenes whose ``scene_features`` are all False, with no mesh, no
image texture and no NEE, run here; the rest raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...core import rng
from ...core import types as T
from ...core.constants import (
    NO_HIT, RAY_OFFSET, SQRT_OF_ONE_THIRD, TRANSMISSION_PUSH, TWO_PI,
)
from ...core.rng import Draw
from ...core.vecmath import as_f32 as _f32
from ...render.integrator import camera_basis, geom_transforms

# Number of launches of the CUDA kernel K1 (``trace_k1`` on a CUDA
# device), so a run can show that it went through the kernel.
LAUNCHES = 0

FEATURE_NAMES = ("glass", "imperfect specular", "depth of field",
                 "motion blur", "checker", "bump", "subsurface scattering")
_K1_FEATURES_TODO = "ROADMAP Queue 1 item 6 (the rest of K1)"
_NEE_TODO = "ROADMAP Queue 1 item 6 (NEE, kernel K2)"
_MESH_TODO = "ROADMAP Queue 1 item 7 (meshes, kernel K3)"
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


def check_supported(scene, nee=False, rr=False):
    """Raise ``NotImplementedError`` for anything K1 does not port yet."""
    if nee:
        raise NotImplementedError(f"NEE is not ported yet: {_NEE_TODO}")
    if rr:
        raise NotImplementedError(
            f"Russian roulette is not ported yet: {_K1_FEATURES_TODO}")
    if scene.mesh.count or any(t == T.MESH for t in scene.geoms.type):
        raise NotImplementedError(f"meshes are not ported yet: {_MESH_TODO}")
    if scene.textures or any(i >= 0 for i in scene.texture_ids) or any(
            i >= 0 for i in scene.bump_texture_ids) or (
            scene.materials.bumptex_strength is not None):
        raise NotImplementedError(
            f"image textures are not ported yet: {_TEX_TODO}")
    on = [n for n, f in zip(FEATURE_NAMES, scene_features(scene)) if f]
    if on:
        raise NotImplementedError(
            f"scene needs {', '.join(on)}, not ported yet: "
            f"{_K1_FEATURES_TODO}")


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


# ----------------------------------------------------------------------------
# plain PyTorch version of K1, on flat (N,) tensors
# ----------------------------------------------------------------------------

def _normalize3(x, y, z):
    # x * (1/sqrt(x.x)), never rsqrt: the reference's rounding
    inv = torch.reciprocal(torch.sqrt(x * x + y * y + z * z))
    return x * inv, y * inv, z * inv


@dataclass
class _Hit:
    hit: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    mc: list   # albedo r, g, b
    ms: list   # specular color r, g, b
    refl: torch.Tensor
    emit: torch.Tensor


def _nearest(ox, oy, oz, dx, dy, dz, mats, gmat, geom_types):
    """Nearest hit over the geoms by world-space distance, the winner
    kept on a strict ``dist < best`` (ties keep the lower index) —
    the reference's unrolled fold with motion, bump, checker and UV off.
    ``mats``/``gmat`` are lists of Python floats."""
    zeros = torch.zeros_like(ox)
    best = torch.full_like(ox, NO_HIT)
    px, py, pz = ox, oy, oz
    nx = ny = nz = zeros
    mc = [zeros] * 3
    ms = [zeros] * 3
    refl = emit = zeros
    for g, gtype in enumerate(geom_types):
        if gtype not in (T.SPHERE, T.CUBE):
            raise NotImplementedError(
                f"K1 traces spheres and cubes; {_MESH_TODO}")
        m = gmat[g]
        # object-space ray (explicit mul-adds)
        rox = m[12] * ox + m[13] * oy + m[14] * oz + m[15]
        roy = m[16] * ox + m[17] * oy + m[18] * oz + m[19]
        roz = m[20] * ox + m[21] * oy + m[22] * oz + m[23]
        rdx = m[12] * dx + m[13] * dy + m[14] * dz
        rdy = m[16] * dx + m[17] * dy + m[18] * dz
        rdz = m[20] * dx + m[21] * dy + m[22] * dz
        rdx, rdy, rdz = _normalize3(rdx, rdy, rdz)

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
            # normal via invT (24..32), flipped inside
            nx0 = m[24] * qx + m[25] * qy + m[26] * qz
            ny0 = m[27] * qx + m[28] * qy + m[29] * qz
            nz0 = m[30] * qx + m[31] * qy + m[32] * qz
            nx0, ny0, nz0 = _normalize3(nx0, ny0, nz0)
            flip = torch.where(both_pos, 1.0, -1.0)
            nx0, ny0, nz0 = nx0 * flip, ny0 * flip, nz0 * flip
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
            nox, noy, noz = (torch.where(inside, nmax[k], nmin[k])
                             for k in range(3))
            # quirk: box normal via the FORWARD transform
            # (src/intersections.h:85)
            nx0 = m[0] * nox + m[1] * noy + m[2] * noz
            ny0 = m[4] * nox + m[5] * noy + m[6] * noz
            nz0 = m[8] * nox + m[9] * noy + m[10] * noz
            nx0, ny0, nz0 = _normalize3(nx0, ny0, nz0)

        # world point + world distance
        pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3]
        pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7]
        pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11]
        ddx, ddy, ddz = ox - pxw, oy - pyw, oz - pzw
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        dist = torch.where(hit, dist, NO_HIT)

        better = dist < best
        row = mats[g]

        def sel(a, b, better=better):
            return torch.where(better, a, b)

        best = sel(dist, best)
        px, py, pz = sel(pxw, px), sel(pyw, py), sel(pzw, pz)
        nx, ny, nz = sel(nx0, nx), sel(ny0, ny), sel(nz0, nz)
        mc = [sel(row[k], mc[k]) for k in range(3)]
        ms = [sel(row[3 + k], ms[k]) for k in range(3)]
        refl = sel(row[7], refl)
        emit = sel(row[10], emit)
    return _Hit(best < NO_HIT, px, py, pz, nx, ny, nz, mc, ms, refl, emit)


def _trace_sample(it, pix, fx, fy, cam, mats, gmat, geom_types,
                  width, height, depth, counts):
    """One sample of every pixel: raygen, then ``depth`` bounces.
    Returns the sample's radiance (r, g, b); adds the live count
    entering each bounce into ``counts``."""
    (pos_x, pos_y, pos_z, v_x, v_y, v_z, r_x, r_y, r_z,
     u_x, u_y, u_z, tan_x, tan_y, _aperture, _focal) = cam

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
    tr = torch.ones_like(dx)
    tg = torch.ones_like(dx)
    tb = torch.ones_like(dx)
    rr = torch.zeros_like(dx)
    rg = torch.zeros_like(dx)
    rb = torch.zeros_like(dx)
    live = torch.ones_like(dx, dtype=torch.bool)
    s3 = _c32(SQRT_OF_ONE_THIRD)

    for d in range(depth):
        counts[d] += live.sum()
        h = _nearest(ox, oy, oz, dx, dy, dz, mats, gmat, geom_types)
        emissive = h.emit > 0.0

        # terminate: emission only on live & hit & emissive
        lit = live & h.hit & emissive
        rr = rr + torch.where(lit, tr * h.mc[0] * h.emit, 0.0)
        rg = rg + torch.where(lit, tg * h.mc[1] * h.emit, 0.0)
        rb = rb + torch.where(lit, tb * h.mc[2] * h.emit, 0.0)

        dep = d + 1
        u_lobe = rng.uniform(it, pix, dep, Draw.LOBE)
        u_d1 = rng.uniform(it, pix, dep, Draw.DIFF_U1)
        u_d2 = rng.uniform(it, pix, dep, Draw.DIFF_U2)
        nx, ny, nz = h.nx, h.ny, h.nz

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
        ddfx = up * nx + ca * over * p1x + sa * over * p2x
        ddfy = up * ny + ca * over * p1y + sa * over * p2y
        ddfz = up * nz + ca * over * p1z + sa * over * p2z

        # mirror
        ndoti = nx * dx + ny * dy + nz * dz
        mrx = dx - 2.0 * ndoti * nx
        mry = dy - 2.0 * ndoti * ny
        mrz = dz - 2.0 * ndoti * nz

        # spec/diffuse lobe split
        p_spec = torch.clamp(h.refl, 0.0, 1.0)
        take_spec = u_lobe < p_spec
        p_safe = torch.clamp_min(
            torch.where(take_spec, p_spec, 1.0 - p_spec), 1e-8)
        ndx = torch.where(take_spec, mrx, ddfx)
        ndy = torch.where(take_spec, mry, ddfy)
        ndz = torch.where(take_spec, mrz, ddfz)
        thr = [torch.where(take_spec, h.ms[k], h.mc[k]) / p_safe
               for k in range(3)]

        # the state changes only where the path continues
        cont = live & h.hit & ~emissive
        ox = torch.where(cont, h.px, ox)
        oy = torch.where(cont, h.py, oy)
        oz = torch.where(cont, h.pz, oz)
        dx = torch.where(cont, ndx, dx)
        dy = torch.where(cont, ndy, dy)
        dz = torch.where(cont, ndz, dz)
        tr = torch.where(cont, tr * thr[0], tr)
        tg = torch.where(cont, tg * thr[1], tg)
        tb = torch.where(cont, tb * thr[2], tb)
        live = cont
    return rr, rg, rb


def trace_plain(cam, mats, gmat, geom_types, width, height, depth, it0,
                n_spp, pix0=0):
    """Plain PyTorch K1 on the device of ``cam``: ``n_spp`` samples of
    pixels ``pix0 ..`` to the end of the image (all of it by default) at
    iterations ``it0 .. it0+n_spp-1``.

    Returns (rad (P - pix0, 3) f32 summed over the samples, counts
    (depth,) int64: live paths entering each bounce, summed over the
    samples)."""
    device = cam.device
    cam_l = cam.reshape(-1).tolist()
    mats_l, gmat_l = mats.tolist(), gmat.tolist()
    pixel = torch.arange(pix0, width * height, dtype=torch.int64,
                         device=device)
    fx = (pixel % width).to(torch.float32)
    fy = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    acc = [torch.zeros_like(fx) for _ in range(3)]
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    for s in range(n_spp):
        rad = _trace_sample(
            (it0 + s) & 0xFFFFFFFF, pixel, fx, fy, cam_l, mats_l,
            gmat_l, tuple(geom_types), width, height, depth, counts)
        acc = [a + r for a, r in zip(acc, rad)]
    return torch.stack(acc, dim=-1), counts


# ----------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ----------------------------------------------------------------------------

_TYPES_ON_DEVICE = {}


def _geom_types_tensor(geom_types, device):
    key = (tuple(geom_types), str(device))
    if key not in _TYPES_ON_DEVICE:
        _TYPES_ON_DEVICE[key] = torch.tensor(key[0], dtype=torch.int32,
                                             device=device)
    return _TYPES_ON_DEVICE[key]


def _check_table(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous float32 {shape} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def trace_k1(cam, mats, gmat, geom_types, width, height, depth, it0, n_spp,
             pix0=0):
    """K1: the same computation and result as :func:`trace_plain`.

    For tensors on the CPU this is :func:`trace_plain`.  For tensors on
    a CUDA device it launches the kernel of ``csrc/megakernel.cu`` on
    the current stream (building it at first use) and raises if the
    build or the launch fails."""
    global LAUNCHES
    device = cam.device
    if device.type == "cpu":
        return trace_plain(cam, mats, gmat, geom_types, width, height,
                           depth, it0, n_spp, pix0)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {device}")
    from . import build

    n_geoms = len(geom_types)
    n_pixels = width * height
    n_local = n_pixels - pix0
    if any(t not in (T.SPHERE, T.CUBE) for t in geom_types):
        raise NotImplementedError(f"K1 traces spheres and cubes; {_MESH_TODO}")
    if not (0 < n_geoms and 0 < depth and 0 <= n_spp and 0 <= pix0
            and 0 < n_local and n_pixels < 2 ** 31):
        raise ValueError(
            f"bad K1 sizes: {n_geoms} geoms, depth {depth}, {n_spp} spp, "
            f"pixels {pix0}+{n_local} of {n_pixels}")
    _check_table("cam", cam, (1, 16), device)
    _check_table("mats", mats, (n_geoms, 24), device)
    _check_table("gmat", gmat, (n_geoms, 40), device)
    types = _geom_types_tensor(geom_types, device)
    rad = torch.empty((n_local, 3), dtype=torch.float32, device=device)
    # the kernel adds into these as unsigned 64-bit integers
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    lib = build.load_k1()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_k1_trace(
            cam.data_ptr(), mats.data_ptr(), gmat.data_ptr(),
            types.data_ptr(), n_geoms, width, height, depth,
            it0 & 0xFFFFFFFF, n_spp, pix0, n_local, rad.data_ptr(),
            counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: CUDA error {err} "
            f"({lib.pt_cuda_error_string(err).decode()})")
    LAUNCHES += 1
    return rad, counts


def prepare(scene, device="cuda", nee=False, rr=False):
    """Check that K1 can render ``scene`` on ``device`` and return its
    packed (cam, mats, gmat) tables there.  Raises
    ``NotImplementedError`` for what is not ported and ``RuntimeError``
    for a CUDA device without a GPU."""
    check_supported(scene, nee=nee, rr=rr)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available")
    return pack_scene(scene, device)


def pathtrace_batch_cuda(scene, it0, n_iters, device="cuda", nee=False,
                         rr=False):
    """``n_iters`` samples per pixel in one K1 launch, mirroring the
    reference's ``pathtrace_batch_pallas``: returns (accumulated radiance
    (P,3) f32, counts (depth,) int64 summed over the samples) on
    ``device``.  A CPU device runs :func:`trace_plain`; a CUDA device
    runs the kernel and raises when there is no GPU."""
    cam, mats, gmat = prepare(scene, device, nee=nee, rr=rr)
    width, height = scene.resolution
    return trace_k1(cam, mats, gmat, scene.geoms.type, width, height,
                    int(scene.trace_depth), it0, n_iters)
