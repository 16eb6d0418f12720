"""The wavefront path-tracing integrator, in torch ops on a device.

Counterpart of ``pathtrace_tpu/render/integrator.py``: raygen, then per
bounce {intersect, shade and scatter, terminate, compact}, then
accumulate, over a struct of per-ray tensors (origins, dirs, throughput,
radiance, pixel ids, live mask) of a fixed size.

* Compaction is a mode.  ``"mask"`` keeps the dead rays in place,
  predicated off; ``"sort"`` moves the live rays to the front after every
  bounce (:func:`_densify`, through ``ops/scan.compact``: the scan K6 on
  a CUDA device, its plain version on the CPU) and un-permutes the
  radiance at the end.  Both give the same image and counts, bit for bit.
* Every draw is a pure function of (iteration, pixel, bounce, draw)
  (``core/rng.uniform``), so the result does not depend on the order of
  the rays, the compaction mode or how samples are grouped.
* The live rays entering each bounce are counted and returned.

The reference jits its iteration and vmaps over samples;
:func:`pathtrace_batch` here loops over samples instead (8 samples at
once at 800x800 would hold 5.1 M rays), and adds each sample's radiance
in turn.  Gradients flow through torch autograd (``render/diff.py``
``engine="wavefront"``), each bounce rematerialized in the backward pass
when ``remat`` (``torch.utils.checkpoint``).

The scene's arrays go to the device once, as tensors
(:func:`resident`), as the reference's ``jax.device_put``; the geoms'
material ids, the triangles' geoms and the texture and light ids stay
on the host, static facts of the scene.  Accumulation follows the
reference: each iteration adds one sample per pixel; display divides
by the iteration count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.constants import PI, TRANSMISSION_PUSH
from ..core.rng import Draw
from ..core.types import CUBE, SPHERE
from ..ops import lights as L
from ..ops.bsdf import sample_bsdf
# triangle_uv_gradients lives in ops/intersect.py; re-exported here
from ..ops.intersect import (  # noqa: F401
    _f32, BARY_UV, intersect_scene, triangle_uv_gradients,
)
from ..scene.textures import sample_texture


def camera_basis(camera, width, height):
    """(view, right, up, tan_fovx, tan_fovy), fovx derived from fovy and
    the aspect ratio as src/scene.cpp:133-136 does.  Tensors keep their
    device; other inputs give CPU tensors."""
    view = vm.normalize(_f32(camera.view))
    right = vm.normalize(vm.cross(view, _f32(camera.up)))
    up = vm.normalize(vm.cross(right, view))
    tan_y = torch.tan(_f32(camera.fovy_deg) * (PI / 180.0))
    tan_x = tan_y * (width / height)
    return view, right, up, tan_x, tan_y


def geom_affine(geoms):
    """TRS -> (forward, inverse), the top three rows of each, (G,3,4):
    :func:`geom_transforms` without the constant bottom row, from one
    rotation per geom."""
    return vm.trs_affine(_f32(geoms.translation), _f32(geoms.rotation),
                         _f32(geoms.scale))


def geom_transforms(geoms):
    """TRS -> (forward, inverse, inverse-transpose), (G,4,4) each — the
    precompute of src/scene.cpp:82-85, differentiable in the TRS."""
    fwd, inv = (vm.homogeneous(m) for m in geom_affine(geoms))
    return fwd, inv, inv.transpose(-1, -2)


def resident(scene, device):
    """``scene`` with its float arrays as float32 tensors on ``device``
    (a tensor moved keeps its graph, so gradients reach the caller's
    leaves; one already there is itself), the maps as tensors too, and
    the integer tables (the geoms' material ids, the triangles' geoms) as
    numpy arrays on the host: the static facts the loops are unrolled
    on."""
    device = torch.device(device)

    def f32(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=device)

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.int64)

    def floats(obj):
        return dataclasses.replace(obj, **{
            f.name: f32(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    g, m = scene.geoms, scene.mesh
    return dataclasses.replace(
        scene,
        materials=floats(scene.materials),
        geoms=dataclasses.replace(
            g, material_id=host(g.material_id),
            translation=f32(g.translation), rotation=f32(g.rotation),
            scale=f32(g.scale), velocity=f32(g.velocity)),
        mesh=dataclasses.replace(m, tri_verts=f32(m.tri_verts),
                                 tri_geom=host(m.tri_geom),
                                 tri_uv=f32(m.tri_uv)),
        camera=floats(scene.camera),
        textures=tuple(f32(t) for t in scene.textures),
    )


def raygen(camera, width, height, it, pixel_ids):
    """Camera rays with per-pixel AA jitter and the thin lens: the sample
    point is (x + u, y + v), u, v uniform over the pixel; with
    ``aperture`` > 0 the origin moves on a disk of that radius and the
    ray aims at the focal plane (aperture 0 is the pinhole ray,
    exactly).  Returns (origins, dirs), (N,3) each."""
    view, right, up, tan_x, tan_y = camera_basis(camera, width, height)
    x = (pixel_ids % width).to(torch.float32)
    y = (pixel_ids // width).to(torch.float32)
    u = rng.uniform(it, pixel_ids, 0, Draw.AA_X)
    v = rng.uniform(it, pixel_ids, 0, Draw.AA_Y)
    sx = 2.0 * (x + u) / width - 1.0
    sy = 2.0 * (y + v) / height - 1.0
    d = vm.normalize(view[None] - right[None] * (tan_x * sx)[:, None]
                     - up[None] * (tan_y * sy)[:, None])
    o = _f32(camera.position)[None].expand(d.shape)

    # the thin lens (PBRT 6.2.3), the identity when aperture == 0
    aperture = _f32(camera.aperture)
    u1 = rng.uniform(it, pixel_ids, 0, Draw.DOF_U)
    u2 = rng.uniform(it, pixel_ids, 0, Draw.DOF_V)
    r_lens = aperture * torch.sqrt(u1)
    theta = u2 * (2.0 * PI)
    offset = (right[None] * (r_lens * torch.cos(theta))[:, None]
              + up[None] * (r_lens * torch.sin(theta))[:, None])
    cos_v = vm.dot(d, view[None].expand(d.shape))
    ft = _f32(camera.focal_dist) / vm.maximum(cos_v[..., 0], 1e-6)
    p_focus = o + d * ft[:, None]
    use_dof = aperture > 0.0
    o_dof = o + offset
    d_dof = vm.normalize(p_focus - o_dof)
    return torch.where(use_dof, o_dof, o), torch.where(use_dof, d_dof, d)


def _take_rows(table, idx):
    """``table[idx]`` for a small table: a where-fold over its rows for
    64 rows or fewer, as the reference's (the backward pass of a fold is
    a fold, with no scatter, so its gradient bits do not depend on the
    order of atomic adds), indexing above.  A numpy table (the integer
    ids of :func:`resident`) is folded from its values on the host."""
    if not isinstance(table, torch.Tensor):
        vals = [int(v) for v in table]
        out = torch.full_like(idx, vals[0])
        for r in range(1, len(vals)):
            out = torch.where(idx == r, vals[r], out)
        return out
    n = table.shape[0]
    if n > 64:
        return table[idx]
    m_shape = idx.shape + (1,) * (table.ndim - 1)
    out = table[0].expand(idx.shape + table.shape[1:])
    for r in range(1, n):
        out = torch.where((idx == r).reshape(m_shape), table[r], out)
    return out


def _gather_material(materials, mid):
    fields = ["color", "spec_color", "spec_exponent", "has_reflective",
              "has_refractive", "ior", "emittance"]
    if materials.sss_sigma is not None:
        fields += ["sss_sigma", "sss_albedo"]
    return {k: _take_rows(getattr(materials, k), mid) for k in fields}


def _uses(ids, mid, tex):
    """(N,) bool: the material ``mid`` maps texture ``tex`` in ``ids``."""
    use = torch.zeros(mid.shape, dtype=torch.bool, device=mid.device)
    for m, t in enumerate(ids):
        if t == tex:
            use = use | (mid == m)
    return use


def _object_point(inv, isect, vel, time):
    """The hit point in the hit geom's object space (motion undone): the
    basis of the procedural textures and bump maps."""
    gi = isect["geom_idx"]
    inv_g = _take_rows(inv, gi)
    pw = isect["point"]
    if vel is not None and time is not None:
        pw = pw - time[:, None] * _take_rows(vel, gi)
    return vm.mat3_vec(inv_g[:, :3, :3], pw) + inv_g[:, :3, 3]


def _tilt(inv_t, gi, n, g_obj, k):
    """``n`` tilted by the object-space height gradient ``g_obj`` with
    strength ``k`` (N,): gradients transform like normals, and only
    their part tangent to ``n`` tilts it; ``n`` where k <= 0."""
    g_w = vm.mat3_vec(_take_rows(inv_t, gi)[:, :3, :3], g_obj)
    g_t = g_w - vm.dot(g_w, n) * n
    n2 = vm.normalize(n - k[:, None] * g_t, eps=1e-20)
    return torch.where((k > 0)[:, None], n2, n)


def _bump_normal(scene, inv_t, q, isect, mid):
    """Procedural bump mapping (the BUMP material line): the analytic
    gradient of h(q) = prod_i sin(w q_i + 0.5) in object space (the 0.5
    phase keeps the field alive on cube faces at +-0.5)."""
    bs = _take_rows(scene.materials.bump_scale, mid)
    bk = _take_rows(scene.materials.bump_strength, mid)
    w = bs * (2.0 * PI)
    ph = 0.5
    sx, cx = torch.sin(w * q[:, 0] + ph), torch.cos(w * q[:, 0] + ph)
    sy, cy = torch.sin(w * q[:, 1] + ph), torch.cos(w * q[:, 1] + ph)
    sz, cz = torch.sin(w * q[:, 2] + ph), torch.cos(w * q[:, 2] + ph)
    g_obj = torch.stack([w * cx * sy * sz, w * sx * cy * sz,
                         w * sx * sy * cz], dim=-1)
    return _tilt(inv_t, isect["geom_idx"], isect["normal"], g_obj, bk)


def _checker_albedo(scene, q, mid, color):
    """The procedural object-space checker (the CHECKER material line):
    the second colour on the odd cells of a 3D lattice in the hit geom's
    object space, offset by 1/64 so that cube faces at +-0.5 do not sit
    on cell boundaries."""
    cs = _take_rows(scene.materials.checker_scale, mid)
    ph = 0.015625
    cells = (torch.floor(q[:, 0] * cs - ph) + torch.floor(q[:, 1] * cs - ph)
             + torch.floor(q[:, 2] * cs - ph))
    # floored modulo, as the reference's jnp.mod
    use2 = (cs > 0) & (torch.remainder(cells, 2.0) >= 1.0)
    c2 = _take_rows(scene.materials.checker_color, mid)
    return torch.where(use2[:, None], c2, color)


def _texture_albedo(scene, uv, mid, color):
    """Image texture mapping (the TEXTURE material line): the material's
    RGB times the bilinear sample at the hit's UV, for each map in turn
    on the rays whose material uses it."""
    out = color
    for t in sorted({t for t in scene.texture_ids if t >= 0}):
        smp = sample_texture(scene.textures[t], uv[:, 0], uv[:, 1])
        out = torch.where(_uses(scene.texture_ids, mid, t)[:, None],
                          out * smp, out)
    return out


def _bumptex_normal(scene, inv_t, q, isect, mid):
    """Image bump mapping (the BUMPTEX material line): tilt the normal by
    the gradient of the map's luminance h(u, v), chained through the
    object-space gradients of each geom type's UV chart: the sphere's
    grad u = (-z, 0, x) / (2 pi (x^2 + z^2)), grad v = (0, 2 /
    sqrt(1 - 4 y^2), 0) / pi; a cube face's the unit object axes it maps
    from; a mesh triangle's its chart gradients, carried through the
    nearest-hit fold as ``isect["tang"]``.  dh/du and dh/dv are one-texel
    central differences of the bilinear sampler."""
    uv = isect["uv"]
    bt = [int(t) for t in scene.bump_texture_ids]
    k = _take_rows(scene.materials.bumptex_strength, mid)

    hu = torch.zeros(mid.shape, dtype=q.dtype, device=q.device)
    hv = torch.zeros_like(hu)
    for t in sorted({t for t in bt if t >= 0}):
        tex = scene.textures[t]
        eu, ev = 1.0 / tex.shape[1], 1.0 / tex.shape[0]

        def lum(du, dv, tex=tex):
            s = sample_texture(tex, uv[:, 0] + du, uv[:, 1] + dv)
            return (s[:, 0] + s[:, 1] + s[:, 2]) * (1.0 / 3.0)

        use = _uses(bt, mid, t)
        hu = torch.where(use, (lum(eu, 0.0) - lum(-eu, 0.0)) / (2.0 * eu),
                         hu)
        hv = torch.where(use, (lum(0.0, ev) - lum(0.0, -ev)) / (2.0 * ev),
                         hv)

    gi = isect["geom_idx"]
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    zero = torch.zeros_like(qx)
    g_obj = torch.zeros_like(q)
    for g, gtype in enumerate(scene.geoms.type):
        if gtype == SPHERE:
            r2 = vm.maximum(qx * qx + qz * qz, 1e-12)
            gu = torch.stack([-qz / (2.0 * PI * r2), zero,
                              qx / (2.0 * PI * r2)], dim=-1)
            den = torch.sqrt(vm.maximum(1.0 - 4.0 * qy * qy, 1e-12))
            gv = torch.stack([zero, 2.0 / (PI * den), zero], dim=-1)
        elif gtype == CUBE:
            ax = torch.argmax(torch.abs(q), dim=-1)  # the face's axis
            ex = torch.eye(3, dtype=q.dtype, device=q.device)
            gu = torch.where((ax == 0)[:, None], ex[2], ex[0])
            gv = torch.where((ax == 1)[:, None], ex[2], ex[1])
        elif "tang" in isect:
            gu, gv = isect["tang"][:, :3], isect["tang"][:, 3:]
        else:
            continue  # a mesh winner without chart data: no tilt
        g_obj = torch.where((gi == g)[:, None],
                            hu[:, None] * gu + hv[:, None] * gv, g_obj)
    return _tilt(inv_t, gi, isect["normal"], g_obj, k)


def _nee_direct(scene, fwd, inv, inv_t, it, pix, dep, isect, mat,
                throughput, eligible, time=None):
    """Direct light (NEE) for the diffuse part at each ``eligible`` hit:
    for each light in turn, one point sampled on it and one shadow ray.
    The diffuse lobe exists on materials that are not glass, and its BRDF
    is albedo / pi whatever the specular probability (the lobes add)."""
    total = torch.zeros_like(throughput)
    has_diffuse = eligible & ~(mat["has_refractive"] > 0.0)
    vel = scene.geoms.velocity
    for k, li in enumerate(scene.light_indices):
        base = Draw.NEE_BASE + 3 * k
        u_sel = rng.uniform(it, pix, dep, base + 0)
        u1 = rng.uniform(it, pix, dep, base + 1)
        u2 = rng.uniform(it, pix, dep, base + 2)
        if scene.geoms.type[li] == SPHERE:
            lp, ln, area = L.sample_sphere_light(fwd[li], inv_t[li], u1, u2)
        else:
            lp, ln, area = L.sample_cube_light(fwd[li], u_sel, u1, u2)
        if vel is not None and time is not None:
            # a moving light: the sampled point at the ray's time
            lp = lp + time[:, None] * vel[li][None]
        l_mid = int(scene.geoms.material_id[li])
        emission = (scene.materials.color[l_mid]
                    * scene.materials.emittance[l_mid])[None]

        # the shadow ray from the (already backed-off) hit point
        wl = lp - isect["point"]
        dist_l = torch.sqrt(vm.maximum(torch.sum(wl * wl, dim=-1), 1e-12))
        shadow = intersect_scene(
            isect["point"], wl / dist_l[:, None], scene.geoms.type, fwd, inv,
            inv_t, tri_verts=scene.mesh.tri_verts if scene.mesh.count
            else None, tri_geom=scene.mesh.tri_geom, velocity=vel,
            time=time)
        # visible iff the nearest hit is this (convex) light at about the
        # sampled distance
        tol = vm.maximum(5e-3 * dist_l, 1e-3)
        visible = (shadow["hit"] & (shadow["geom_idx"] == li)
                   & (torch.abs(shadow["dist"] - dist_l) < tol))
        contrib = L.nee_contribution(
            isect["point"], isect["normal"], mat["color"], throughput, lp,
            ln, area, emission, ~visible)
        total = total + torch.where(has_diffuse[:, None], contrib, 0.0)
    return total


def _bounce(scene, tabs, it, depth, state, nee=False, rr=False):
    """One wavefront bounce: intersect, terminate and accumulate,
    scatter.  ``tabs``: :func:`_tables` of the scene.  With ``nee``,
    every diffuse hit also samples each light (next-event estimation),
    and the emission a diffuse-sampled ray finds next is not counted
    again.  Returns the next state."""
    fwd, inv, inv_t = tabs["fwd"], tabs["inv"], tabs["inv_t"]
    m = scene.materials
    o, d = state["origins"], state["dirs"]
    vel = scene.geoms.velocity
    time = state.get("time")
    has_tex = any(t >= 0 for t in scene.texture_ids)
    has_btex = any(t >= 0 for t in scene.bump_texture_ids)
    isect = intersect_scene(
        o, d, scene.geoms.type, fwd, inv, inv_t,
        tri_verts=scene.mesh.tri_verts if scene.mesh.count else None,
        tri_geom=scene.mesh.tri_geom, velocity=vel, time=time,
        tri_uv=scene.mesh.tri_uv, want_uv=has_tex or has_btex,
        tri_tang=tabs["tri_tang"])
    mid = _take_rows(scene.geoms.material_id, isect["geom_idx"])
    mat = _gather_material(m, mid)
    if has_tex:
        mat["color"] = _texture_albedo(scene, isect["uv"], mid, mat["color"])
    if (m.checker_scale is not None or m.bump_strength is not None
            or has_btex):
        q = _object_point(inv, isect, vel, time)
    if m.checker_scale is not None:
        mat["color"] = _checker_albedo(scene, q, mid, mat["color"])
    if m.bump_strength is not None:
        isect["normal"] = _bump_normal(scene, inv_t, q, isect, mid)
    if has_btex:
        isect["normal"] = _bumptex_normal(scene, inv_t, q, isect, mid)

    live, hit = state["live"], isect["hit"]
    emissive = mat["emittance"] > 0.0
    thr = state["throughput"]

    # an emissive hit ends the path and adds throughput x emission; a
    # miss adds nothing.  Under NEE only rays whose last bounce was not
    # diffuse (or the camera's) may collect emission found this way
    add = thr * mat["color"] * mat["emittance"][:, None]
    lit = live & hit & emissive
    if nee:
        lit = lit & state["emit_ok"]
    radiance = state["radiance"] + torch.where(lit[:, None], add, 0.0)

    pix = state["pixel"]
    dep = depth + 1  # depth slot 0 is raygen's
    u = {name: rng.uniform(it, pix, dep, draw) for name, draw in (
        ("lobe", Draw.LOBE), ("diff_u1", Draw.DIFF_U1),
        ("diff_u2", Draw.DIFF_U2), ("fresnel", Draw.FRESNEL),
        ("spec_u1", Draw.SPEC_U1), ("spec_u2", Draw.SPEC_U2))}
    new_dir, thr_mult, took_diffuse, took_refract = sample_bsdf(
        d, isect["normal"], isect["outside"], mat, u)
    cont = live & hit & ~emissive

    sss = m.sss_sigma is not None
    if sss:
        # inside an SSS medium a ray random-walks (exponential free
        # paths, isotropic phase, albedo attenuation) until a step
        # reaches the exit surface, where the Fresnel interface takes over
        in_med = state["med_sigma"] > 0.0
        u_step = rng.uniform(it, pix, dep, Draw.SSS_STEP)
        step = (-torch.log(vm.maximum(1.0 - u_step, 1e-7))
                / vm.maximum(state["med_sigma"], 1e-8))
        scatter_inside = in_med & live & hit & (step < isect["dist"])

    if nee:
        radiance = radiance + _nee_direct(
            scene, fwd, inv, inv_t, it, pix, dep, isect, mat, thr,
            cont & ~scatter_inside if sss else cont, time=time)

    new_thr = thr * thr_mult
    # The transmission fix: the hit point backs off 1e-4 before the
    # surface, right for reflection but a trap for a refracted ray,
    # which would meet the same interface at once; it moves past the
    # interface by 5e-4 x the geom's largest |scale|
    push = TRANSMISSION_PUSH * _take_rows(tabs["max_scale"],
                                          isect["geom_idx"])
    next_origin = torch.where(took_refract[:, None],
                              isect["point"] + push[:, None] * new_dir,
                              isect["point"])
    next_dir = new_dir
    if sss:
        zi = 1.0 - 2.0 * rng.uniform(it, pix, dep, Draw.SSS_U)
        ri = torch.sqrt(vm.maximum(1.0 - zi * zi, 0.0))
        phi = rng.uniform(it, pix, dep, Draw.SSS_V) * (2.0 * PI)
        d_iso = torch.stack([ri * torch.cos(phi), ri * torch.sin(phi), zi],
                            dim=-1)
        si3 = scatter_inside[:, None]
        next_origin = torch.where(si3, o + step[:, None] * d, next_origin)
        next_dir = torch.where(si3, d_iso, next_dir)
        new_thr = torch.where(si3, thr * state["med_albedo"], new_thr)
    if rr and depth >= 3:
        # Russian roulette from bounce 3 on: end with probability 1 - p,
        # p following the throughput, and boost the survivors by 1 / p
        p_srv = vm.clip(torch.amax(new_thr, dim=-1), 0.05, 1.0)
        survive = rng.uniform(it, pix, dep, Draw.RR) < p_srv
        cont = cont & survive
        new_thr = new_thr * torch.where(survive, 1.0 / p_srv, 1.0)[:, None]

    c3 = cont[:, None]
    out = dict(state, origins=torch.where(c3, next_origin, o),
               dirs=torch.where(c3, next_dir, d),
               throughput=torch.where(c3, new_thr, thr),
               radiance=radiance, live=cont)
    if sss:
        at_surface = cont & ~scatter_inside
        entering = (at_surface & took_refract & (mat["sss_sigma"] > 0.0)
                    & isect["outside"])
        exiting = at_surface & took_refract & in_med & ~isect["outside"]
        out["med_sigma"] = torch.where(
            entering, mat["sss_sigma"],
            torch.where(exiting, 0.0, state["med_sigma"]))
        out["med_albedo"] = torch.where(
            entering[:, None], mat["sss_albedo"],
            torch.where(exiting[:, None], 1.0, state["med_albedo"]))
    if nee:
        out["emit_ok"] = ~took_diffuse
        if sss:
            # an interior scattering event samples no light, so the
            # emission found next counts
            out["emit_ok"] = out["emit_ok"] | scatter_inside
    return out


def _densify(state):
    """The live rays moved to the front, in order, then the dead ones
    (``compaction="sort"``): ``ops/scan.compact``, whose scan is K6 on a
    CUDA device and its plain version on the CPU.  The permutation is a
    stable argsort of the dead flag; the draws are keyed on the pixel id,
    so it changes no result."""
    from ..ops.scan import compact

    return compact(state["live"], state)[0]


def _tables(scene):
    """What every bounce reads of the scene, made once a sample: the
    geom transforms, each geom's largest |scale| (the transmission push)
    and, for bump maps on meshes, each triangle's chart gradients."""
    fwd, inv, inv_t = geom_transforms(scene.geoms)
    tri_tang = None
    if scene.mesh.count and any(t >= 0 for t in scene.bump_texture_ids):
        tri_uv = scene.mesh.tri_uv
        if tri_uv is None:
            tri_uv = torch.tensor(BARY_UV, dtype=torch.float32,
                                  device=fwd.device)[None].expand(
                scene.mesh.count, 3, 2)
        tri_tang = torch.cat(triangle_uv_gradients(scene.mesh.tri_verts,
                                                   tri_uv), dim=-1)
    return dict(fwd=fwd, inv=inv, inv_t=inv_t, tri_tang=tri_tang,
                max_scale=torch.amax(torch.abs(_f32(scene.geoms.scale)),
                                     dim=-1))


def trace_pixels(scene, it, pixel_ids, compaction="mask", remat=True,
                 nee=False, rr=False):
    """One sample of each pixel in ``pixel_ids`` (a 1-D int64 tensor on
    the device of a :func:`resident` scene) at iteration ``it``: (radiance
    (N,3) f32 in the order of ``pixel_ids``, live counts (depth,) int64:
    the rays entering each bounce).  Every draw is keyed on the global
    pixel id, so a subset of pixels gives the rows the whole image
    would.  ``remat``: each bounce recomputed in the backward pass
    (``torch.utils.checkpoint``) when autograd records, so the backward
    pass does not hold every bounce's intermediates."""
    if compaction not in ("mask", "sort"):
        raise ValueError(f"compaction must be 'mask' or 'sort', not "
                         f"{compaction!r}")
    width, height = scene.resolution
    n = pixel_ids.shape[0]
    device = pixel_ids.device
    it = int(it)
    tabs = _tables(scene)
    origins, dirs = raygen(scene.camera, width, height, it, pixel_ids)
    state = dict(
        origins=origins, dirs=dirs,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=device),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=device),
        pixel=pixel_ids,
        live=torch.ones((n,), dtype=torch.bool, device=device))
    if scene.geoms.velocity is not None:
        # motion blur: one shutter time per camera sample
        state["time"] = rng.uniform(it, pixel_ids, 0, Draw.TIME)
    if scene.materials.sss_sigma is not None:
        state["med_sigma"] = torch.zeros((n,), dtype=torch.float32,
                                         device=device)
        state["med_albedo"] = torch.ones((n, 3), dtype=torch.float32,
                                         device=device)
    if nee:
        state["emit_ok"] = torch.ones((n,), dtype=torch.bool, device=device)
    if compaction == "sort":
        # each ray's input row, carried through the permutations
        state["row"] = torch.arange(n, device=device)

    def body(depth, state):
        nxt = _bounce(scene, tabs, it, depth, state, nee=nee, rr=rr)
        return _densify(nxt) if compaction == "sort" else nxt

    counts = []
    for depth in range(scene.trace_depth):
        counts.append(state["live"].sum())
        if remat and torch.is_grad_enabled():
            state = torch.utils.checkpoint.checkpoint(
                body, depth, state, use_reentrant=False,
                preserve_rng_state=False)
        else:
            state = body(depth, state)
    # paths alive after the last bounce add nothing (black)
    radiance = state["radiance"]
    if compaction == "sort":
        # back to the input order: one scatter of each row to its place
        radiance = torch.zeros_like(radiance).index_copy(
            0, state["row"], radiance)
    return radiance, torch.stack(counts) if counts else torch.zeros(
        0, dtype=torch.int64, device=device)


def pathtrace_iteration(scene, it, compaction="mask", remat=True, nee=False,
                        rr=False, device="cuda"):
    """One progressive-refinement iteration (one sample a pixel) at
    iteration ``it`` (1-based, as the reference's): (radiance (P,3) f32,
    live counts (depth,) int64; the reference's are int32), on
    ``device``.  ``compaction``: "mask" or "sort" (the module's
    docstring); ``remat``: :func:`trace_pixels`'."""
    from ..ops.cuda.megakernel import resolve_device

    device = resolve_device(device)
    scene = resident(scene, device)
    pixel_ids = torch.arange(scene.pixel_count, device=device)
    return trace_pixels(scene, it, pixel_ids, compaction, remat, nee, rr)


def pathtrace_batch(scene, it0, n_iters, compaction="mask", remat=True,
                    nee=False, rr=False, device="cuda"):
    """The sum of ``n_iters`` iterations from ``it0``, one sample after
    another: (accumulated radiance (P,3) f32, live counts (n_iters,
    depth) int64; the reference's are int32), on ``device``."""
    from ..ops.cuda.megakernel import resolve_device

    device = resolve_device(device)
    scene = resident(scene, device)
    pixel_ids = torch.arange(scene.pixel_count, device=device)
    acc = torch.zeros((scene.pixel_count, 3), dtype=torch.float32,
                      device=device)
    counts = []
    for i in range(n_iters):
        rad, c = trace_pixels(scene, it0 + i, pixel_ids, compaction, remat,
                              nee, rr)
        acc = acc + rad
        counts.append(c)
    return acc, (torch.stack(counts) if counts else torch.zeros(
        (0, scene.trace_depth), dtype=torch.int64, device=device))


def render(scene, n_iters=None, chunk=8, compaction="mask", callback=None,
           nee=False, device="cuda"):
    """Progressive render to completion, ``chunk`` iterations a call of
    :func:`pathtrace_batch`, the scene resident on ``device`` throughout:
    the accumulated image (P,3) (divide by ``n_iters`` for display).
    ``callback(done, accum, counts)`` runs after each chunk, with the
    chunk's counts (chunk, depth)."""
    from ..ops.cuda.megakernel import resolve_device

    n_iters = n_iters if n_iters is not None else scene.iterations
    device = resolve_device(device)
    scene = resident(scene, device)
    accum = torch.zeros((scene.pixel_count, 3), dtype=torch.float32,
                        device=device)
    done = 0
    while done < n_iters:
        step = min(chunk, n_iters - done)
        rad, counts = pathtrace_batch(scene, done + 1, step, compaction,
                                      remat=False, nee=nee, device=device)
        accum = accum + rad
        done += step
        if callback is not None:
            callback(done, accum, counts)
    return accum
