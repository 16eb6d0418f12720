"""Forward path-trace megakernel (K1, with NEE: K2, with meshes: K3,
with image textures: K4): host side, plain version, wrapper.

Counterpart of ``pathtrace_tpu/ops/pallas/megakernel.py`` for the
forward render path: ``pack_scene``, ``pack_lights``, ``pack_mesh`` and
``pack_textures`` build the same ``cam``/``mats``/``gmat``/``lights``/
``tri``/``nodes`` tables and texels as ``_pack_scene``, ``_pack_lights``
and ``_pack_textures``, and ``tex_spec``/``btex_spec`` the same
per-geom texture charts; ``prepare`` checks them once into a ``Job``,
which every launcher takes; ``trace_k1`` launches the CUDA kernel
``csrc/megakernel.cu`` (which replaces the Pallas ``_kernel``), built
once per feature set as Mosaic specializes the reference's; and
``trace_plain`` is the same computation in plain PyTorch, one element per
pixel, following the kernel's own math and operation order (not the
wavefront integrator's).

Every scene file renders here: spheres, cubes and triangle meshes (one
skip-link BVH walk per ray and MESH geom; a mesh stripped of its BVH,
every triangle folded: K3-linear, the gradients' oracle); diffuse, mirror,
imperfect-specular, glass, emissive and subsurface materials; depth of
field, motion blur, checker and bump; image textures (bilinear albedo
maps and BUMPTEX height maps); NEE and Russian roulette.  The kernel
reads texels as bytes (``pack_textures``), so a texture whose texels are
not on the u8 grid raises ``ValueError`` on its routes; the plain version
also reads a float texel table (``pack_textures_f32``, ``prepare(...,
texels="f32")``), which renders such a map and carries the graph of a
map that requires grad: the planes engine's route (``--engine planes``,
``render/diff`` with ``engine="planes"``), the texel gradients'.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Mapping
from types import MappingProxyType, SimpleNamespace

import numpy as np
import torch

from ...core import rng
from ...core import types as T
from ...core.constants import (
    NO_HIT, PI, RAY_OFFSET, SQRT_OF_ONE_THIRD, TRANSMISSION_PUSH, TWO_PI,
)
from ...core.rng import Draw
from ...core.vecmath import as_f32 as _f32
from ...ops.intersect import triangle_uv_gradients
from ...render.integrator import camera_basis, geom_affine
from ...utils import profiling
from .. import lights as L
from .bound import needed as _needed
from .bound import read as _read
from .bound import tally as _tally

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
TEX_BIT = MESH_BIT << 1   # an albedo TEXTURE chart on some geom
BTEX_BIT = TEX_BIT << 1   # a BUMPTEX chart on some geom
LINEAR_BIT = BTEX_BIT << 1  # with MESH_BIT: the meshes have no BVH (K3-linear)
LIGHT_COLS = 128
TRI_COLS = 16  # v0 (3), e1 (3), e2 (3), object-space unit normal (3), pad
TRI_TEX_COLS = 24  # + vt corners (6), BUMPTEX UV gradients (6)
NO_CHART = (-1, 0, 0)
# K1's event counters (csrc/megakernel.cu K1Events), a row a bounce: the
# scatter events by kind (a path that goes on from a surface), then the mesh
# walks and the BVH nodes they visit by kind of ray: rays that leave a
# refraction, the other nearest-hit rays, shadow rays.
SCATTER_KINDS = ("diffuse", "specular", "glass_reflection", "refraction")
RAY_KINDS = ("refracted", "other", "shadow")
K1_EVENTS = SCATTER_KINDS + tuple(f"{what}.{ray}" for ray in RAY_KINDS
                                  for what in ("walks", "nodes"))


def _c32(x):
    """A Python float holding float32(x): the constant the reference
    rounds to f32 before it meets a plane."""
    return float(np.float32(x))


def _host(x):
    """``x`` as a numpy array (a tensor detached: a leaf of
    ``render/diff.requires_grad``)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def scene_features(scene):
    """(has_glass, has_imperfect, has_dof, has_motion, has_checker,
    has_bump, has_sss): the static scene facts the reference specializes
    its kernel on (``_scene_features``)."""
    m = scene.materials
    return (
        bool(np.any(_host(m.has_refractive) > 0)),
        bool(np.any(_host(m.spec_exponent) > 0)),
        bool(_host(scene.camera.aperture) > 0),
        scene.geoms.velocity is not None,
        m.checker_scale is not None,
        m.bump_strength is not None,
        m.sss_sigma is not None,
    )


def feature_mask(features, nee, rr, mesh=False, tex=False, btex=False,
                 linear=False):
    """The kernel's compile-time feature set as an int: bit i for
    ``FEATURE_NAMES[i]``, then ``NEE_BIT``, ``RR_BIT``, ``MESH_BIT`` (the
    scene has a MESH geom), ``TEX_BIT`` (some geom has an albedo chart),
    ``BTEX_BIT`` (some geom has a BUMPTEX chart) and ``LINEAR_BIT`` (the
    meshes have no BVH: every triangle is folded)."""
    mask = sum(1 << i for i, on in enumerate(features) if on)
    return (mask | (NEE_BIT if nee else 0) | (RR_BIT if rr else 0)
            | (MESH_BIT if mesh else 0) | (TEX_BIT if tex else 0)
            | (BTEX_BIT if btex else 0)
            | (LINEAR_BIT if mesh and linear else 0))


def scene_mask(scene, nee=False, rr=False):
    """``feature_mask`` of ``scene`` rendered with these options."""
    tex_geom, btex_geom = tex_statics(scene)
    mesh = any(t == T.MESH for t in scene.geoms.type)
    return feature_mask(scene_features(scene), nee, rr, mesh,
                        bool(tex_geom), bool(btex_geom),
                        mesh and bool(scene.mesh.count)
                        and not scene.mesh.bvh_meta)


def resolve_device(device):
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a
    CUDA device when there is no GPU, rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available")
    return device


# ----------------------------------------------------------------------------
# image textures (K4): the texel table and the per-geom charts
# ----------------------------------------------------------------------------

def tex_used(scene):
    """The texture ids (albedo and bump maps) that some geom's material
    uses, sorted: the order of the texel table (``_tex_used``)."""
    mids = {int(m) for m in np.asarray(scene.geoms.material_id)}
    used = {scene.texture_ids[m] for m in mids if scene.texture_ids[m] >= 0}
    used |= {scene.bump_texture_ids[m] for m in mids
             if scene.bump_texture_ids[m] >= 0}
    return tuple(sorted(used))


def tex_offsets(scene):
    """{texture id: (offset, H, W)} of each used map in the texel table
    (``_tex_offsets``)."""
    offs, off = {}, 0
    for t in tex_used(scene):
        h, w = (int(x) for x in scene.textures[t].shape[:2])
        offs[t] = (off, h, w)
        off += h * w
    return offs


def _spec(scene, ids):
    offs = tex_offsets(scene)
    return tuple(offs[ids[int(m)]] if ids[int(m)] >= 0 else NO_CHART
                 for m in np.asarray(scene.geoms.material_id))


def tex_spec(scene):
    """Per-geom albedo chart (offset, H, W) in the texel table;
    ``NO_CHART`` (-1, 0, 0) for a geom without a TEXTURE (``_tex_spec``)."""
    return _spec(scene, scene.texture_ids)


def btex_spec(scene):
    """Per-geom BUMPTEX chart, as :func:`tex_spec` (``_btex_spec``)."""
    return _spec(scene, scene.bump_texture_ids)


def tex_statics(scene):
    """(tex_geom, btex_geom): :func:`tex_spec` and :func:`btex_spec`, each
    () when no geom has such a chart, so that a mode with nothing to do
    is off (the reference's ``_tex_statics``)."""
    tg, bg = tex_spec(scene), btex_spec(scene)
    return (tg if any(c[0] >= 0 for c in tg) else (),
            bg if any(c[0] >= 0 for c in bg) else ())


def _texel_words(tex, tid):
    """(H*W,) int64 words ``r | g << 8 | b << 16`` of one map, its texels
    rounded to bytes; raises ``ValueError`` for a texel off the u8 grid
    (the test of the reference's ``_tex_in_kernel``)."""
    x = _host(tex).astype(np.float32)
    if not np.array_equal(np.round(x * 255.0) / np.float32(255.0), x):
        raise ValueError(
            f"texture {tid} has texels off the u8 grid (k/255): the CUDA "
            f"kernel reads texels as bytes; such a map renders on the "
            f"planes engine (--engine planes, engine='planes', "
            f"prepare(..., texels='f32'))")
    q = np.round(x * 255.0).astype(np.int64).reshape(-1, 3)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def pack_textures(scene, device="cuda"):
    """The texel table: the used maps (:func:`tex_used` order,
    :func:`tex_offsets` offsets) row-major, one int32 word per texel,
    ``r | g << 8 | b << 16`` with each channel ``round(x * 255)`` (the
    kernel reads them as uint32); None for a scene without a used map.
    Raises ``ValueError`` for a texel off the u8 grid, and (as every
    ``pack_*``) ``RuntimeError`` for a CUDA device without a GPU."""
    device = resolve_device(device)
    used = tex_used(scene)
    if not used:
        return None
    words = np.concatenate([_texel_words(scene.textures[t], t)
                            for t in used])
    return torch.as_tensor(words.astype(np.int32)).to(device)


def pack_textures_f32(scene, device="cuda"):
    """The float texel table of the plain version: the used maps
    (:func:`tex_used` order, :func:`tex_offsets` offsets) row-major, an
    (H*W total, 3) float32 tensor on ``device``; None for a scene without
    a used map.  Made with torch ops, so a map that requires grad keeps
    its graph (the texel gradients), and any texel value renders.  On a
    map on the u8 grid, :func:`trace_plain` reads from it the bits it
    reads through :func:`pack_textures`' words."""
    device = resolve_device(device)
    used = tex_used(scene)
    if not used:
        return None
    return torch.cat([_f32(scene.textures[t]).reshape(-1, 3)
                      for t in used]).to(device)


def pack_scene(scene, device="cuda"):
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
    device = resolve_device(device)
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

    fwd, inv = geom_affine(scene.geoms)
    n_g = fwd.shape[0]
    vel = scene.geoms.velocity
    vel = _f32(vel) if vel is not None else torch.zeros((n_g, 3))
    push = TRANSMISSION_PUSH * torch.amax(
        torch.abs(_f32(scene.geoms.scale)), dim=-1)[:, None]
    gmat = torch.cat([
        fwd.reshape(-1, 12), inv.reshape(-1, 12),
        inv[:, :, :3].transpose(1, 2).reshape(-1, 9),
        vel, push, torch.zeros((n_g, 3)),
    ], dim=1)
    return cam.to(device), mats.to(device), gmat.to(device)


def pack_lights(scene, device="cuda"):
    """The NEE light table of the reference's ``_pack_lights``: (lights
    (L,128) float32 on ``device``, ((geom index, type), ...) per light),
    or (None, ()) for a scene with no emissive geom, which NEE then
    renders plain.  Row layout: 0 geom index | 1 type | 2-4 emission |
    cube: 5 total area, 6-11 area cdf, 12-29 face origins, 30-47 e_b,
    48-65 e_c, 66-83 outward normals | sphere: 12-20 forward 3x3, 21-23
    center, 24-32 invT 3x3, 33 |det M3| | 120-122 velocity.  Computed on
    the CPU in float32, as ``pack_scene``."""
    device = resolve_device(device)
    if not scene.light_indices:
        return None, ()
    fwd, inv = geom_affine(scene.geoms)
    m = scene.materials
    color, emittance = _f32(m.color), _f32(m.emittance)
    vel = scene.geoms.velocity
    rows, statics = [], []
    for li in scene.light_indices:
        ltype = int(scene.geoms.type[li])
        statics.append((int(li), ltype))
        mid = int(scene.geoms.material_id[li])
        if ltype == T.SPHERE:
            body = [torch.zeros(7), fwd[li][:, :3].reshape(-1), fwd[li][:, 3],
                    inv[li][:, :3].transpose(0, 1).reshape(-1),
                    L.sphere_det3(fwd[li])[None], torch.zeros(86)]
        else:
            tab = L.cube_light_tables(fwd[li])
            area = tab["area"].unbind()
            total = area[0]
            for a in area[1:]:
                total = total + a
            body = [total[None],
                    torch.cumsum(tab["area"], 0) / torch.clamp_min(total,
                                                                   1e-20),
                    *(tab[k].reshape(-1)
                      for k in ("origin", "e_b", "e_c", "normal")),
                    torch.zeros(36)]
        rows.append(torch.cat([
            torch.tensor([float(li), float(ltype)]),
            color[mid] * emittance[mid], *body,
            _f32(vel)[li] if vel is not None else torch.zeros(3),
            torch.zeros(LIGHT_COLS - 123)]))
    return torch.stack(rows).to(device), tuple(statics)


def pack_mesh(scene, device="cuda"):
    """The triangle tables of the reference's ``_pack_scene`` (its BVH
    branch): (tri (T,16) or (T,24), nodes (N,16)) float32 tensors on
    ``device`` and the static ``bvh_meta``, or (None, None, ()) for a
    scene with no triangles.

    * tri: one row per triangle in BVH (leaf-contiguous) order: v0 (3),
      e1 = v1 - v0 (3), e2 = v2 - v0 (3), the object-space unit normal
      cross(e1, e2) / max(|.|, 1e-20) (3), zeros (4).  In a scene with a
      texture chart (:func:`tex_statics`), 24 columns: columns 12..17
      hold the corners' vt (u0 v0 u1 v1 u2 v2; [[0,0],[1,0],[0,1]] when
      the OBJ had none) and 18..23 the UV gradients (grad_u, grad_v,
      :func:`triangle_uv_gradients`) when a MESH geom has a BUMPTEX
      chart, else zeros.  The reference keeps 16 columns where the only
      chart is a BUMPTEX chart on a sphere or cube; here the row width
      follows the kernel build (``TEX_BIT``/``BTEX_BIT``) instead;
    * nodes: ``scene.mesh.bvh_nodes`` (``scene/bvh.py``: aabb min and
      max, skip link, leaf start and count, as float32);
    * bvh_meta: ((geom, node_off, n_nodes, tri_off, n_tris), ...), one
      entry per MESH geom that owns triangles.

    A mesh without a BVH (``bvh_meta`` empty: ``scene/bvh.without_bvh``)
    packs the form K3-linear folds, the reference's ``use_bvh=False``:
    the same rows in the mesh's own triangle order, nodes None, and the
    per-triangle geom index (``tri_geom``) as ``bvh_meta`` entries (geom,
    0, 0, tri_off, n_tris), one per run of triangles of one geom.  Its UV
    gradients are zeros: the reference's linear fold leaves a mesh's
    BUMPTEX inert (``plane_engine.py`` warns of it), and so does this.

    Computed on the CPU in float32, as ``pack_scene``; the norm is the
    square root of the sum of squares, rounded once (through float64).
    """
    device = resolve_device(device)
    mesh = scene.mesh
    if not mesh.count:
        return None, None, ()
    linear = not mesh.bvh_meta
    # the rows in BVH (leaf-contiguous) order, or in the mesh's own
    order = (slice(None) if linear else
             torch.as_tensor(np.asarray(mesh.bvh_order), dtype=torch.int64))
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
    tex_geom, btex_geom = tex_statics(scene)
    if tex_geom or btex_geom:
        uv = (_f32(mesh.tri_uv)[order] if mesh.tri_uv is not None else
              torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]).expand(
                  tv.shape[0], 3, 2))
        if not linear and any(c[0] >= 0 and t == T.MESH
                              for c, t in zip(btex_geom, scene.geoms.type)):
            tail = torch.cat(triangle_uv_gradients(tv, uv), dim=1)
        else:
            tail = torch.zeros((tv.shape[0], 6))
        tri = torch.cat([tri[:, :12], uv.reshape(-1, 6), tail], dim=1)
    if linear:
        geom = np.asarray(mesh.tri_geom).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, geom[1:] != geom[:-1]])
        ends = np.r_[starts[1:], len(geom)]
        meta = tuple((int(geom[a]), 0, 0, int(a), int(b - a))
                     for a, b in zip(starts, ends))
        return tri.to(device), None, meta
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
    ``scalar / tensor`` as a reciprocal times the scalar.  ``a`` is a
    Python float or a 0-d tensor (a table entry, whose graph carries
    on)."""
    return (a.expand_as(t) if torch.is_tensor(a)
            else torch.full_like(t, a)) / t


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


def _moller_trumbore(ray, row, bary=False):
    """Ray (rox, roy, roz, rdx, rdy, rdz) against the triangles of
    ``row`` (N,16) (``pack_mesh`` layout): (tt, hit), and with ``bary``
    also the barycentrics (u, vv) of v1 and v2."""
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
    hit = ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (tt > 0.0)
    return (tt, hit, u, vv) if bary else (tt, hit)


def _mesh_walk(ray, t0, want, nodes, tri, tri_off, events=None):
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
    per ray (int64, -1: none).  ``events`` = (a bounce's row of K1's
    event counters, each ray's kind: an int64 tensor or an int, an index
    of :data:`RAY_KINDS`) counts each walk and each node it visits, a
    node a loop step, as K1 does."""
    widx = torch.full_like(t0, -1, dtype=torch.int64)
    live = torch.nonzero(want).squeeze(1)
    rays = torch.stack(ray, dim=1)[live]
    t_loc = t0[live]
    win = torch.full_like(live, -1)
    cur = torch.zeros_like(live)
    n_nodes = nodes.shape[0]
    if events is not None:
        ev_row, kind = events
        kind = kind[live] if torch.is_tensor(kind) else \
            torch.full_like(live, kind)
        walks = ev_row[len(SCATTER_KINDS)::2]  # then each kind's nodes
        walks += torch.bincount(kind, minlength=len(RAY_KINDS))
    while live.numel():
        if events is not None:
            ev_row[len(SCATTER_KINDS) + 1::2] += torch.bincount(
                kind, minlength=len(RAY_KINDS))
        with _needed("walk", compacted=True):
            node = nodes[cur]
            _read(nodes, "nodes", cur, 9)
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
                # the leaf's k-th triangle, on the rays whose leaf has one
                with _needed("walk", k < cnt, compacted=True):
                    _read(tri, "tri", row, 9)
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
            if events is not None:
                kind = kind[keep]
    return widx


# elements (rays x triangles) of one chunk of K3-linear's plain fold
LINEAR_CHUNK = 1 << 22


def _linear_walk(m, go, ray, best, want, tri, tri_off, n_tris):
    """K3-linear's fold, per ray (the reference's ``tri_body``): each ray
    in ``want`` meets every triangle of rows ``tri_off ..
    tri_off+n_tris`` of ``tri``, in order, each hit a candidate of the
    world-space fold against ``best`` (the world distance of the winner
    so far) with the strict ``<``, so the first of two equal distances
    wins.  ``ray`` is the object-space ray of the geom whose gmat row is
    ``m``, ``go`` its world origin (moved back by the shutter time).  The
    rays are kept compacted and meet the triangles in chunks (the winner
    is the first row of the smallest distance).  Returns the winner's row
    in ``tri`` per ray (int64, -1: none)."""
    widx = torch.full_like(best, -1, dtype=torch.int64)
    live = torch.nonzero(want).squeeze(1)
    if not live.numel():
        return widx
    rray = [c[live][:, None] for c in ray]
    gx, gy, gz = (c[live][:, None] for c in go)
    t_best = best[live]
    win = torch.full_like(live, -1)
    chunk = max(1, LINEAR_CHUNK // live.numel())
    for c0 in range(tri_off, tri_off + n_tris, chunk):
        c1 = min(c0 + chunk, tri_off + n_tris)
        with _needed("linear", compacted=True):
            _read(tri, "tri", range(c0, c1), 9)
            tt, hit = _moller_trumbore(rray, tri[c0:c1])
            # the world distance, needed only where the ray test hits
            # (the kernel's `continue` on a miss)
            with _needed(lanes=hit):
                tofs = tt - RAY_OFFSET
                qx = rray[0] + tofs * rray[3]
                qy = rray[1] + tofs * rray[4]
                qz = rray[2] + tofs * rray[5]
                ddx = gx - (m[0] * qx + m[1] * qy + m[2] * qz + m[3])
                ddy = gy - (m[4] * qx + m[5] * qy + m[6] * qz + m[7])
                ddz = gz - (m[8] * qx + m[9] * qy + m[10] * qz + m[11])
                dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
                # a miss, or a distance that is NaN, never wins (counted
                # as the kernel's one comparison a candidate)
                ok = hit & ~torch.isnan(dist)
        # the winner so far first: argmin keeps the first of equal
        # minima, so a candidate must be strictly nearer to win
        k = torch.argmin(torch.cat(
            [t_best[:, None], torch.where(ok, dist, float("inf"))], 1), 1)
        t_best = torch.where(k > 0, dist.gather(
            1, (k - 1).clamp_min(0)[:, None]).squeeze(1), t_best)
        win = torch.where(k > 0, c0 + k - 1, win)
    widx[live] = win
    return widx


def _nearest(ox, oy, oz, dx, dy, dz, time, gmat, geom_types, shadow=False,
             mesh=None, want=None, uv=False, events=None):
    """Nearest hit over the geoms by world-space distance, the winner
    kept on a strict ``dist < best`` (ties keep the geom folded first):
    the spheres and cubes in index order, then each MESH geom of
    ``mesh`` = (tri, nodes, bvh_meta) in ``bvh_meta`` order (a BVH walk,
    :func:`_mesh_walk`, then one fold of its winning triangle; without
    nodes, K3-linear's fold of every triangle, :func:`_linear_walk`).
    The winner search runs detached, as the reference's ``bvh_grad``
    traversal does: autograd reaches the tables through the fold of the
    winner's row, which a lane without one takes on a unit normal and a
    unit distance so that the gradients stay finite there.
    ``gmat`` is a list of rows of 0-d tensors; ``time`` is the shutter
    time (motion blur) or None; ``want`` (bool, optional) marks the rays
    whose result is read: only they walk the meshes.  Returns the
    winner's ``dist``, ``geom`` (int64, -1 on a miss) and ``hit``;
    unless ``shadow``, also its world point ``p*``, normal ``n*``
    (before bump), object-space point ``q*`` and ``outside``; with ``uv``
    (the texture builds) also its chart coordinates ``u``, ``v`` (a
    cube's face chart, a triangle's interpolated vt; zero on a sphere,
    whose chart :func:`_surface` computes from ``q*``) and its triangle
    row ``row`` (-1: not a triangle).  The shadow form skips the normals;
    its distances and winners are those of the full fold.  ``events``
    counts the BVH walks (:func:`_mesh_walk`'s)."""
    zeros = torch.zeros_like(ox)
    h = SimpleNamespace(dist=torch.full_like(ox, NO_HIT),
                        geom=torch.full_like(ox, -1, dtype=torch.int64))
    if not shadow:
        h.px, h.py, h.pz = ox, oy, oz
        h.nx = h.ny = h.nz = h.qx = h.qy = h.qz = zeros
        h.outside = torch.zeros_like(ox, dtype=torch.bool)
        if uv:
            h.u = h.v = zeros
            h.row = torch.full_like(ox, -1, dtype=torch.int64)

    def fold(g, m, hit, q, go, shade=None, row0=-1):
        """World point and distance of the candidate hits (object-space
        point ``q``), folded into ``h`` where nearer, with the normal,
        ``outside`` and chart coordinates that ``shade()`` makes (needed
        only where nearer)."""
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
        dist = torch.sqrt(torch.where(hit, ddx * ddx + ddy * ddy + ddz * ddz,
                                      1.0))
        dist = torch.where(hit, dist, NO_HIT)
        better = dist < h.dist
        h.dist = torch.where(better, dist, h.dist)
        h.geom = torch.where(better, g, h.geom)
        if shadow:
            return

        def sel(a, b):
            return torch.where(better, a, b)

        with _needed(lanes=better):
            n0, out0, uv0 = shade()
        h.px, h.py, h.pz = sel(pxw, h.px), sel(pyw, h.py), sel(pzw, h.pz)
        h.nx, h.ny, h.nz = sel(n0[0], h.nx), sel(n0[1], h.ny), \
            sel(n0[2], h.nz)
        h.qx, h.qy, h.qz = sel(qx, h.qx), sel(qy, h.qy), sel(qz, h.qz)
        h.outside = sel(out0, h.outside)
        if uv:
            h.u, h.v = sel(uv0[0], h.u), sel(uv0[1], h.v)
            h.row = sel(row0, h.row)

    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            continue  # folded after the primitives, by bvh_meta
        m = gmat[g]
        go, (rox, roy, roz, rdx, rdy, rdz) = _object_ray(
            m, ox, oy, oz, dx, dy, dz, time)
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

            def shade():
                # normal via invT (24..32), flipped inside
                nx0 = m[24] * qx + m[25] * qy + m[26] * qz
                ny0 = m[27] * qx + m[28] * qy + m[29] * qz
                nz0 = m[30] * qx + m[31] * qy + m[32] * qz
                nx0, ny0, nz0 = _normalize3(nx0, ny0, nz0)
                flip = torch.where(both_pos, 1.0, -1.0)
                return ((nx0 * flip, ny0 * flip, nz0 * flip), both_pos,
                        (zeros, zeros))
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

            def shade():
                nox, noy, noz = (torch.where(inside, nmax[k], nmin[k])
                                 for k in range(3))
                # quirk: box normal via the FORWARD transform
                # (src/intersections.h:85)
                n0 = _normalize3(m[0] * nox + m[1] * noy + m[2] * noz,
                                 m[4] * nox + m[5] * noy + m[6] * noz,
                                 m[8] * nox + m[9] * noy + m[10] * noz)
                # the face chart: planar in the two axes off the slab's
                # object-space face normal
                uv0 = (torch.where(torch.abs(nox) > 0.0, qz, qx) + 0.5,
                       torch.where(torch.abs(noy) > 0.0, qz, qy) + 0.5) \
                    if uv else None
                return n0, ~inside, uv0
        fold(g, m, hit, (qx, qy, qz), go, shade)

    tri, nodes, bvh_meta = mesh if mesh is not None else (None, None, ())
    want = torch.ones_like(ox, dtype=torch.bool) if want is None else want
    for g, node_off, n_nodes, tri_off, n_tris in bvh_meta:
        m = gmat[g]
        go, ray = _object_ray(m, ox, oy, oz, dx, dy, dz, time)
        rox, roy, roz, rdx, rdy, rdz = ray
        with torch.no_grad():
            if nodes is None:
                widx = _linear_walk(m, go, ray, h.dist, want, tri, tri_off,
                                    n_tris)
            else:
                # exact object-space pruning bound from the winner so far:
                # dist = (t - RAY_OFFSET) * |L rd| with L the linear part
                # of the forward transform, so t_bound = dist / |L rd| +
                # RAY_OFFSET (+ slack)
                wdx = m[0] * rdx + m[1] * rdy + m[2] * rdz
                wdy = m[4] * rdx + m[5] * rdy + m[6] * rdz
                wdz = m[8] * rdx + m[9] * rdy + m[10] * rdz
                s_ray = torch.sqrt(wdx * wdx + wdy * wdy + wdz * wdz)
                t0 = (h.dist / torch.clamp_min(s_ray, 1e-20)
                      * _c32(1.0 + 1e-5) + RAY_OFFSET + 1e-4)
                widx = _mesh_walk(
                    (*ray, _div(1.0, rdx), _div(1.0, rdy), _div(1.0, rdz)),
                    t0, want, nodes[node_off:node_off + n_nodes], tri,
                    tri_off, events)
        # the shading fold, once, on the winning row (a zero row for none)
        with _needed(lanes=lambda: widx >= 0):
            row = _rows(tri, widx)
            tt, hit, bu, bv = _moller_trumbore(ray, row, bary=True)
            hit = hit & (widx >= 0)
            tofs = tt - RAY_OFFSET
            qx, qy, qz = rox + tofs * rdx, roy + tofs * rdy, roz + tofs * rdz

            def shade():
                # the ray-facing geometric normal through invT
                _read(tri, "tri shading", widx, 9 if uv else 3)
                nox, noy, noz = (torch.where(hit, row[:, 9 + k], float(k == 0))
                                 for k in range(3))
                face = rdx * nox + rdy * noy + rdz * noz
                flip = torch.where(face < 0.0, 1.0, -1.0)
                n0 = _normalize3(
                    (m[24] * nox + m[25] * noy + m[26] * noz) * flip,
                    (m[27] * nox + m[28] * noy + m[29] * noz) * flip,
                    (m[30] * nox + m[31] * noy + m[32] * noz) * flip)
                uv0 = None
                if uv:
                    # the vt corners at columns 12..17, interpolated
                    bw = 1.0 - bu - bv
                    uv0 = (bw * row[:, 12] + bu * row[:, 14] + bv * row[:, 16],
                           bw * row[:, 13] + bu * row[:, 15] + bv * row[:, 17])
                return n0, hit & (face < 0.0), uv0
            fold(g, m, hit, (qx, qy, qz), go, shade, widx)
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


def _atan_poly(t):
    """The reference's degree-11 odd minimax atan on [0, 1]: its float32
    coefficients, its Horner order."""
    t2 = t * t
    p = t2 * _c32(-0.0040540580)
    for c in (0.0218612288, -0.0559098861, 0.0964200441, -0.1390853351,
              0.1994653599, -0.3332985605):
        p = t2 * (_c32(c) + p)
    return t * (_c32(0.9999993329) + p)


def _atan2(y, x):
    """atan2 as the reference's kernel computes it (``_atan2``: the
    polynomial and quadrant selects, never libm's): the sphere chart's
    boundary texels depend on its bits."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    r = _atan_poly(lo / torch.clamp_min(hi, _c32(1e-30)))
    r = torch.where(ay > ax, _c32(0.5 * PI) - r, r)
    r = torch.where(x < 0.0, _c32(PI) - r, r)
    return torch.where(y < 0.0, -r, r)


def _asin(t):
    """asin(t) = atan2(t, sqrt(1 - t^2)) for t in [-1, 1] (``_asin``);
    the square root through float64, correctly rounded on every
    device."""
    c = torch.clamp_min(1.0 - t * t, 0.0)
    return _atan2(t, torch.sqrt(c.double()).float())


def _sphere_uv(qx, qy, qz):
    """The unit sphere's chart at object-space point q: (u, v)."""
    return (0.5 + _atan2(qz, qx) * _c32(1.0 / TWO_PI),
            0.5 + _asin(torch.clamp(2.0 * qy, -1.0, 1.0)) * _c32(1.0 / PI))


def _tap(x0f):
    """A floored texel coordinate as an integer, held inside +-2^24 first
    (the kernel clamps the same way before its float-to-int cast)."""
    x0f = torch.where(x0f >= -16777216.0, x0f, -16777216.0)
    return torch.clamp_max(x0f, 16777216.0).to(torch.int64)


def _bilin3(tex, chart, u, v):
    """The bilinear rgb sample of each lane's map (``_bilin3``): chart
    (N,3) int64 rows (offset, H, W) in ``tex.texels`` (offset -1: none,
    its u, v zeroed first); wrap, then filter, texel centres at
    integer + 0.5, the modulo floored.  The taps read the kernel's
    words through ``tex.byte``, or rows of a float table
    (``pack_textures_f32``) at the same indices."""
    off, th, tw = chart.unbind(1)
    on = off >= 0
    u = torch.where(on, u, 0.0)
    v = torch.where(on, v, 0.0)
    x = u * tw.to(torch.float32) - 0.5
    y = v * th.to(torch.float32) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    wi, hi = torch.clamp_min(tw, 1), torch.clamp_min(th, 1)
    x0 = torch.remainder(_tap(x0f), wi)
    x1 = torch.remainder(x0 + 1, wi)
    y0 = torch.remainder(_tap(y0f), hi)
    y1 = torch.remainder(y0 + 1, hi)
    base = torch.clamp_min(off, 0)
    taps = []
    for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
        # a word a texel, or its 3 floats
        _read(tex.texels, "texels", base + yy * wi + xx,
              1 if tex.byte is not None else 3)
        tap = tex.texels[base + yy * wi + xx]
        taps.append(tap if tex.byte is None else tap.to(torch.int64))
    out = []
    for c in range(3):
        if tex.byte is None:
            c00, c01, c10, c11 = (t[:, c] for t in taps)
        else:
            c00, c01, c10, c11 = (tex.byte[(t >> (8 * c)) & 255]
                                  for t in taps)
        top = c00 * (1.0 - fx) + c01 * fx
        bot = c10 * (1.0 - fx) + c11 * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return out


def _bumptex(n, h, u, v, chart, on, k, t, kind, tang, tex):
    """BUMPTEX (``_make_tracer``'s post-fold section): central differences
    of the height map's luminance in (u, v), chained through the chart's
    object-space gradients (sphere, cube face by the dominant |q| axis,
    a triangle's carried (grad_u, grad_v) ``tang``), then the geom's
    inverse-transpose ``t`` (9 columns), and the normal ``n`` tilted
    tangentially by strength ``k``; where ``on`` (the lane has a chart
    and ``k`` > 0).  ``kind`` is the winner's geom type."""
    _, bh, bw = chart.unbind(1)
    eu = _div(1.0, torch.clamp_min(bw.to(torch.float32), 1.0))
    ev = _div(1.0, torch.clamp_min(bh.to(torch.float32), 1.0))
    zero = torch.zeros_like(u)

    def lum(du, dv):
        r = _bilin3(tex, chart, u + du, v + dv)
        return (r[0] + r[1] + r[2]) * _c32(1.0 / 3.0)

    hu = (lum(eu, zero) - lum(-eu, zero)) / (2.0 * eu)
    hv = (lum(zero, ev) - lum(zero, -ev)) / (2.0 * ev)
    qx, qy, qz = h.qx, h.qy, h.qz
    sph, msh = kind == T.SPHERE, kind == T.MESH
    with _needed(lanes=sph):
        # sphere chart
        r2s = torch.clamp_min(qx * qx + qz * qz, 1e-12)
        inv2pir2 = _div(1.0, _c32(TWO_PI) * r2s)
        den = torch.sqrt(torch.clamp_min(1.0 - 4.0 * qy * qy, 1e-12))
        s_gux, s_guz = -qz * inv2pir2, qx * inv2pir2
        s_gvy = _div(2.0, _c32(PI) * den)
    with _needed(lanes=lambda: ~sph & ~msh):
        # cube face: the dominant |q| axis, the first of equal ones
        aqx, aqy, aqz = torch.abs(qx), torch.abs(qy), torch.abs(qz)
        ax0 = (aqx >= aqy) & (aqx >= aqz)
        ax1 = ~ax0 & (aqy >= aqz)
    g = [torch.where(sph, s_gux, torch.where(ax0, 0.0, 1.0)), zero,
         torch.where(sph, s_guz, torch.where(ax0, 1.0, 0.0)), zero,
         torch.where(sph, s_gvy, torch.where(ax1, 0.0, 1.0)),
         torch.where(sph, 0.0, torch.where(ax1, 1.0, 0.0))]
    if tang is not None:
        g = [torch.where(msh, tang[:, i], g[i]) for i in range(6)]
    gox = hu * g[0] + hv * g[3]
    goy = hu * g[1] + hv * g[4]
    goz = hu * g[2] + hv * g[5]
    gwx = t[0] * gox + t[1] * goy + t[2] * goz
    gwy = t[3] * gox + t[4] * goy + t[5] * goz
    gwz = t[6] * gox + t[7] * goy + t[8] * goz
    nx, ny, nz = n
    gdn = gwx * nx + gwy * ny + gwz * nz
    pxn = nx - k * (gwx - gdn * nx)
    pyn = ny - k * (gwy - gdn * ny)
    pzn = nz - k * (gwz - gdn * nz)
    len2 = pxn * pxn + pyn * pyn + pzn * pzn
    nrm = torch.sqrt(torch.where(on & (len2 > 0.0), len2, 1.0))
    return (torch.where(on, pxn / nrm, nx), torch.where(on, pyn / nrm, ny),
            torch.where(on, pzn / nrm, nz))


def _surface(h, mats, gmat, checker, bump, tex=None):
    """The winner's material row (``row[:, k]``), albedo (checker, then
    the TEXTURE map) and shading normal (bump, then the BUMPTEX map),
    computed after the fold from its object-space point and chart: the
    arithmetic of the reference's per-geom fold and post-fold texture
    sections on the same inputs.  ``tex`` (the texture builds): the
    texel table and per-geom charts of :func:`_tex_planes`."""
    row = _rows(mats, h.geom)
    albedo = [row[:, 0], row[:, 1], row[:, 2]]
    odd = None
    if checker:
        cs = row[:, 11]
        with _needed(lanes=lambda: cs > 0.0):
            ph = 0.015625
            cells = (torch.floor(h.qx * cs - ph) + torch.floor(h.qy * cs - ph)
                     + torch.floor(h.qz * cs - ph))
            odd = (cs > 0.0) & (cells - 2.0 * torch.floor(cells * 0.5) >= 1.0)
        albedo = [torch.where(odd, row[:, 12 + k], albedo[k])
                  for k in range(3)]
    n = (h.nx, h.ny, h.nz)
    if bump:
        with _needed(lanes=lambda: row[:, 16] > 0.0):
            t = _rows(gmat, h.geom)[:, 24:33].unbind(1)
            n = _bump_perturb(*n, h.qx, h.qy, h.qz, row[:, 15], row[:, 16],
                              t)
    if tex is not None:
        kind = tex.kind[h.geom]
        # the lanes that take the albedo map (not on a checker's odd
        # cells, which replace the albedo) and the BUMPTEX map
        a_on = b_on = torch.zeros_like(h.hit)
        if tex.albedo is not None:
            chart = tex.albedo[h.geom]
            a_on = chart[:, 0] >= 0
            if odd is not None:
                a_on = a_on & ~odd
        if tex.bump is not None:
            b_chart = tex.bump[h.geom]
            b_on = (b_chart[:, 0] >= 0) & (row[:, 21] > 0.0)
        with _needed("texture", lambda: (kind == T.SPHERE) & (a_on | b_on)):
            su, sv = _sphere_uv(h.qx, h.qy, h.qz)
        u = torch.where(kind == T.SPHERE, su, h.u)
        v = torch.where(kind == T.SPHERE, sv, h.v)
        if tex.albedo is not None:
            with _needed("texture", a_on):
                smp = _bilin3(tex, chart, u, v)
                albedo = [torch.where(a_on, albedo[k] * smp[k], albedo[k])
                          for k in range(3)]
        if tex.bump is not None:
            tang = None
            if tex.tri is not None:
                tang = _rows(tex.tri, h.row)[:, 18:24]
                with _needed(lanes=b_on):
                    _read(tex.tri, "tri tangents", h.row, 6)
            with _needed("texture", b_on):
                n = _bumptex(n, h, u, v, b_chart, b_on, row[:, 21],
                             _rows(gmat, h.geom)[:, 24:33].unbind(1), kind,
                             tang, tex)
    return row, albedo, n


def _tex_planes(texels, tex_geom, btex_geom, geom_types, tri):
    """What :func:`_surface` reads of the textures: the texel words
    (int32) and the byte -> float32 table k/255 (IEEE quotients, the
    loader's), or a float (n,3) table and no byte table, the albedo and
    BUMPTEX charts as (G+1,3) int64 tables
    indexed by the winning geom (row G, a miss: no chart; None for a
    mode without charts), the geom types (G+1,) and the triangle rows
    (the BUMPTEX gradients of a mesh winner)."""
    device = texels.device

    def charts(spec):
        if not spec:
            return None
        return torch.tensor(tuple(spec) + (NO_CHART,), dtype=torch.int64,
                            device=device)

    return SimpleNamespace(
        texels=texels,
        byte=None if texels.is_floating_point() else torch.as_tensor(
            np.arange(256, dtype=np.float32) / np.float32(255.0)).to(device),
        albedo=charts(tex_geom), bump=charts(btex_geom),
        kind=torch.tensor(tuple(geom_types) + (-1,), dtype=torch.int64,
                          device=device),
        tri=tri if btex_geom and T.MESH in geom_types else None)


def _clip01(x):
    """clamp(x, 0, 1) as the reference's ``jnp.clip``: a maximum, then a
    minimum, whose gradient at a tie is split in half (``clamp``'s is
    not): REFL 0 and 1, the probabilities of most materials, are ties."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


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
             lights, gmat, geom_types, mesh, events=None):
    """Direct lighting at the hit points: per light one area sample and
    one shadow ray, added where ``has_diffuse`` and the light is seen,
    with weight albedo/pi (the reference's ``_nee_add``).  ``lights``
    is a list of table rows of 0-d tensors.  A light that is not a
    sphere is sampled as a cube, as the reference does (an emissive
    mesh too).  ``events``, a bounce's row of K1's event counters, counts
    the shadow rays' walks."""
    nx, ny, nz = n
    rad = list(rad)
    for k, lr in enumerate(lights):
        with _needed("nee", has_diffuse):
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
                w_area = (_c32(PI) * lr[33]) * n_len
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
                    o, eb, ec = 12 + 3 * f, 30 + 3 * f, 48 + 3 * f
                    nn = 66 + 3 * f
                    with _needed(lanes=mface):
                        lpx = torch.where(
                            mface, lr[o] + ss * lr[eb] + tt * lr[ec], lpx)
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
                          geom_types, shadow=True, mesh=mesh, want=has_diffuse,
                          events=None if events is None else (
                              events, RAY_KINDS.index("shadow")))
            tol = torch.clamp_min(5e-3 * dist_l, 1e-3)
            visible = sh.hit & (sh.geom == li) & (
                torch.abs(sh.dist - dist_l) < tol)
            w_ok = has_diffuse & visible
            with _needed(lanes=w_ok):
                cos_s = torch.clamp_min(nx * sdx + ny * sdy + nz * sdz, 0.0)
                cos_l = torch.clamp_min(
                    -(lnx * sdx + lny * sdy + lnz * sdz), 0.0)
                gterm = cos_s * cos_l / r2_safe * w_area
                for c in range(3):
                    # (1/pi) * emission is one f32 product, as XLA folds
                    # the reference's two scalar factors
                    e_pi = _c32(1.0 / PI) * lr[2 + c]
                    rad[c] = rad[c] + torch.where(
                        w_ok, thr[c] * albedo[c] * e_pi * gterm, 0.0)
    return rad


# K7's counters of a path's factors per material (``bounces``'
# ``grad_mats``): color, spec_color, emittance, 1/p (a specular bounce),
# 1/(1-p) (a diffuse bounce).  The reference packs the first four as
# base-64 digits of one float32 and keeps the last apart.
GRAD_COUNTERS = ("color", "spec_color", "emittance", "inv_p", "inv_1mp")


def state_keys(features, nee, pix=False):
    """The state a path carries between bounces, as the names of K5's
    planes (a copy of the reference's ``_state_keys``): origin,
    direction, throughput, radiance and ``live``; ``emit_ok`` with NEE,
    ``time`` with motion blur, the medium ``med_*`` with SSS; with
    ``pix`` (the sorted engine) the pixel id last."""
    (_, _, _, has_motion, _, _, has_sss) = features
    keys = ["ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",
            "rr", "rg", "rb", "live"]
    if nee:
        keys.append("emit_ok")
    if has_motion:
        keys.append("time")
    if has_sss:
        keys += ["med_s", "med_r", "med_g", "med_b"]
    if pix:
        keys.append("pix")
    return tuple(keys)


def plain_scene(cam, mats, gmat, geom_types, features=NO_FEATURES,
                lights=None, rr=False, tri=None, nodes=None, bvh_meta=(),
                texels=None, tex_geom=(), btex_geom=(), **_):
    """What :func:`init_state` and :func:`bounces` read of a scene:
    the tables of a :class:`Job`, the small ones (cam,
    gmat, lights) also as rows of 0-d tensors, the scalars the planes
    meet.  A 0-d float32 tensor rounds as a Python float does in these
    ops, and it carries the graph of a table that requires grad, so
    that autograd over the plain version reaches every table entry."""
    return SimpleNamespace(
        cam=cam.reshape(-1).unbind(), mats=mats, gmat_t=gmat,
        gmat=[row.unbind() for row in gmat],
        lights=([row.unbind() for row in lights] if lights is not None
                else None),
        geom_types=tuple(geom_types), features=tuple(features), rr=rr,
        mesh=(tri, nodes, tuple(bvh_meta)) if bvh_meta else None,
        tex=(_tex_planes(texels, tex_geom, btex_geom, geom_types, tri)
             if tex_geom or btex_geom else None))


def init_state(sc, it, pix, width, height):
    """Raygen (antialias jitter, then the thin lens) of the pixels
    ``pix`` (int64) at iteration ``it``: the state entering bounce 0, a
    dict of the :func:`state_keys` but ``pix`` (``live`` and ``emit_ok``
    bool; the reference's ``init_state``)."""
    (_, _, has_dof, has_motion, _, _, has_sss) = sc.features
    (pos_x, pos_y, pos_z, v_x, v_y, v_z, r_x, r_y, r_z,
     u_x, u_y, u_z, tan_x, tan_y, aperture, focal) = sc.cam
    fx = (pix % width).to(torch.float32)
    fy = torch.div(pix, width, rounding_mode="floor").to(torch.float32)

    ujx = rng.uniform(it, pix, 0, Draw.AA_X)
    ujy = rng.uniform(it, pix, 0, Draw.AA_Y)
    sx = (fx + ujx) * _c32(2.0 / width) - 1.0
    sy = (fy + ujy) * _c32(2.0 / height) - 1.0
    dx = v_x - r_x * (tan_x * sx) - u_x * (tan_y * sy)
    dy = v_y - r_y * (tan_x * sx) - u_y * (tan_y * sy)
    dz = v_z - r_z * (tan_x * sx) - u_z * (tan_y * sy)
    dx, dy, dz = _normalize3(dx, dy, dz)
    ox = pos_x.expand_as(dx).contiguous()
    oy = pos_y.expand_as(dx).contiguous()
    oz = pos_z.expand_as(dx).contiguous()
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
        _tally("dof", lambda: torch.ones_like(dx, dtype=torch.bool))
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    st = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, tr=one, tg=one,
              tb=one, rr=zero, rg=zero, rb=zero,
              live=torch.ones_like(dx, dtype=torch.bool))
    if sc.lights is not None:
        st["emit_ok"] = torch.ones_like(dx, dtype=torch.bool)
    if has_motion:
        st["time"] = rng.uniform(it, pix, 0, Draw.TIME)
    if has_sss:
        st.update(med_s=zero, med_r=one, med_g=one, med_b=one)
    return st


def bounces(sc, st, it, pix, d0, d1, counts, grad_mats=None, events=None):
    """Bounces [d0, d1) of iteration ``it`` on the state ``st`` of the
    pixels ``pix`` (a dict of :func:`init_state`'s form, left as it is);
    returns the state after them and adds the live count entering each
    bounce into ``counts[d]``.  Every section runs on every lane and
    selects, as the reference's planes do.  Each section marks the lanes
    that need it (``bound.needed``), so that a bound counts only the work
    that the kernel must do.

    ``grad_mats`` = (number of materials M, the material of each geom)
    turns on K7's factor counters (the reference's grad mode): the state
    carries ``grad``, (5, M, N) int32 counts of each path's factors per
    material, in the order of :data:`GRAD_COUNTERS` (seeded at zero when
    ``st`` has none).

    ``events`` (depth, len(:data:`K1_EVENTS`)) int64 counts K1's events
    of bounces from 0 on (``d0`` 0): each bounce's scatter events, and its
    walks and their nodes."""
    (has_glass, has_imperfect, _, _, has_checker, has_bump,
     has_sss) = sc.features
    nee = sc.lights is not None
    mats_t, gmat_t, gmat, lights = sc.mats, sc.gmat_t, sc.gmat, sc.lights
    geom_types, rr_mode, mesh, tex = sc.geom_types, sc.rr, sc.mesh, sc.tex
    ox, oy, oz, dx, dy, dz = (st[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                               "dz"))
    thr_acc = [st["tr"], st["tg"], st["tb"]]
    rad = [st["rr"], st["rg"], st["rb"]]
    live = st["live"]
    emit_ok = st.get("emit_ok", torch.ones_like(live))
    time = st.get("time")
    med_s = st.get("med_s", torch.zeros_like(dx))
    med = [st.get(k, torch.ones_like(dx)) for k in ("med_r", "med_g", "med_b")]
    s3 = _c32(SQRT_OF_ONE_THIRD)
    if grad_mats is not None:
        n_mats, mat_of_geom = grad_mats
        cnt = st.get("grad")
        if cnt is None:
            cnt = torch.zeros((len(GRAD_COUNTERS), n_mats, dx.shape[0]),
                              dtype=torch.int32, device=dx.device)
        # each geom's material, and -1 for a miss (geom -1)
        mat_of = torch.tensor(tuple(mat_of_geom) + (-1,), dtype=torch.int64,
                              device=dx.device)
        mat_ids = torch.arange(n_mats, device=dx.device)[:, None]
    if events is not None:
        # the rays that leave a refraction: of RAY_KINDS, 0 ("refracted")
        from_refract = torch.zeros_like(live)

    for d in range(d0, d1):
        counts[d] += live.sum()
        ev = None
        if events is not None:
            ev = (events[d], torch.where(from_refract, 0, 1))
        with _needed("trace", live):
            h = _nearest(ox, oy, oz, dx, dy, dz, time, gmat, geom_types,
                         mesh=mesh, want=live, uv=tex is not None, events=ev)
        with _needed("surface", lambda: live & h.hit):
            row, albedo, (nx, ny, nz) = _surface(h, mats_t, gmat_t,
                                                 has_checker, has_bump, tex)
            emit = row[:, 10]
            emissive = emit > 0.0

        # emission ends the path; with NEE only after a non-diffuse
        # bounce (or from the camera), so light is not counted twice
        lit = live & h.hit & emissive
        if nee:
            lit = lit & emit_ok
        with _needed("surface", lit):
            rad = [rad[c] + torch.where(lit, thr_acc[c] * albedo[c] * emit,
                                        0.0) for c in range(3)]

        cont = live & h.hit & ~emissive
        dep = d + 1
        # the scattering, where the path goes on: each lobe on the lanes
        # that take it
        with _needed("scatter", cont):
            is_glass = (row[:, 8] > 0.0) if has_glass \
                else torch.zeros_like(cont)
            with _needed(lanes=lambda: ~is_glass):
                # spec/diffuse lobe split (glass: the Fresnel choice)
                u_lobe = rng.uniform(it, pix, dep, Draw.LOBE)
                p_spec = _clip01(row[:, 7])
                take_spec = u_lobe < p_spec
                p_safe = torch.clamp_min(
                    torch.where(take_spec, p_spec, 1.0 - p_spec), 1e-8)
            spec = take_spec & ~is_glass

            with _needed(lanes=lambda: ~take_spec & ~is_glass):
                # diffuse: cosine hemisphere with the Peter-Kutz frame
                u_d1 = rng.uniform(it, pix, dep, Draw.DIFF_U1)
                u_d2 = rng.uniform(it, pix, dep, Draw.DIFF_U2)
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

            with _needed(lanes=spec | is_glass):
                ndoti = nx * dx + ny * dy + nz * dz
            mirror = spec
            if has_glass:
                with _needed(lanes=is_glass):
                    # Fresnel glass: Schlick's choice between the mirror
                    # and the Snell refraction (always the mirror under
                    # total internal reflection); no division by the
                    # choice's probability
                    u_fr = rng.uniform(it, pix, dep, Draw.FRESNEL)
                    cos_i = torch.clamp(-ndoti, 0.0, 1.0)
                    ior = row[:, 9]
                    r0 = (1.0 - ior) / (1.0 + ior)
                    r0 = r0 * r0
                    mm = torch.clamp_min(1.0 - cos_i, 0.0)
                    refl_p = r0 + (1.0 - r0) * mm * mm * mm * mm * mm
                    eta = torch.where(
                        h.outside,
                        torch.reciprocal(torch.clamp_min(ior, 1e-6)), ior)
                    kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
                    k_ok = kk >= 0.0
                    choose_refl = (u_fr < refl_p) | ~k_ok
                took_refract = is_glass & ~choose_refl
                mirror = spec | (is_glass & choose_refl)
                with _needed(lanes=took_refract):
                    sqk = torch.sqrt(torch.where(k_ok, kk, 1.0))
                    rf = [eta * dk - (eta * ndoti + sqk) * nk
                          for dk, nk in ((dx, nx), (dy, ny), (dz, nz))]

            # mirror, and the power-cosine lobe about it
            with _needed(lanes=mirror):
                mr = (dx - 2.0 * ndoti * nx, dy - 2.0 * ndoti * ny,
                      dz - 2.0 * ndoti * nz)
            sp = mr
            if has_imperfect:
                with _needed(lanes=lambda: spec & (row[:, 6] > 0.0)):
                    sp = _imperfect_specular(
                        row[:, 6], *mr,
                        rng.uniform(it, pix, dep, Draw.SPEC_U1),
                        rng.uniform(it, pix, dep, Draw.SPEC_U2))

            ndir = [torch.where(take_spec, sp[k], ddf[k]) for k in range(3)]
            with _needed(lanes=lambda: ~is_glass):
                thr = [torch.where(take_spec, row[:, 3 + k], albedo[k])
                       / p_safe for k in range(3)]
            took_diffuse = ~take_spec
            if has_glass:
                ndir = [torch.where(is_glass,
                                    torch.where(choose_refl, mr[k], rf[k]),
                                    ndir[k]) for k in range(3)]
                thr = [torch.where(is_glass,
                                   torch.where(choose_refl, row[:, 3 + k],
                                               albedo[k]), thr[k])
                       for k in range(3)]
                took_diffuse = took_diffuse & ~is_glass

            if events is not None:
                # the path's scatter event, of SCATTER_KINDS
                kind = torch.where(took_diffuse, 0, 1)
                if has_glass:
                    kind = torch.where(is_glass,
                                       torch.where(choose_refl, 2, 3), kind)
                events[d, :len(SCATTER_KINDS)] += torch.bincount(
                    kind[cont], minlength=len(SCATTER_KINDS))

            if grad_mats is not None:
                # the factors this bounce multiplies into the path, by
                # the winner's material: a diffuse bounce color and
                # 1/(1-p), a specular one spec_color and 1/p, an emissive
                # hit color and emittance, glass spec_color (reflected)
                # or color (refracted)
                sel = mat_of[h.geom][None, :] == mat_ids
                ev_diff, ev_spec = cont & took_diffuse, cont & spec
                ev_col, ev_spc = ev_diff | lit, ev_spec
                if has_glass:
                    ev_col = ev_col | (cont & took_refract)
                    ev_spc = ev_spc | (cont & is_glass & choose_refl)
                cnt = cnt + torch.stack([
                    ev[None, :] & sel for ev in (ev_col, ev_spc, lit,
                                                 ev_spec, ev_diff)]).to(
                                                     torch.int32)

            scatter_inside = torch.zeros_like(cont)
            if has_sss:
                # inside a medium: an exponential free path; ending
                # before the surface, the ray scatters there
                in_med = med_s > 0.0
                with _needed(lanes=in_med):
                    u_step = rng.uniform(it, pix, dep, Draw.SSS_STEP)
                    sss_step = -torch.log(
                        torch.clamp_min(1.0 - u_step, 1e-7)) \
                        / torch.clamp_min(med_s, 1e-8)
                    scatter_inside = in_med & live & h.hit & (
                        sss_step < h.dist)

            op = [h.px, h.py, h.pz]
            if has_glass:
                # refracted continuations start past the interface
                with _needed(lanes=took_refract):
                    push = _rows(gmat_t, h.geom)[:, 36]
                    op = [torch.where(took_refract, op[k] + push * ndir[k],
                                      op[k]) for k in range(3)]

            if nee:
                has_diffuse = cont & ~scatter_inside & ~(row[:, 8] > 0.0)
                rad = _nee_add(rad, thr_acc, h, (nx, ny, nz), albedo,
                               has_diffuse, time, it, pix, dep, lights, gmat,
                               geom_types, mesh,
                               None if events is None else events[d])

            if has_sss:
                with _needed(lanes=scatter_inside):
                    # isotropic scatter inside, attenuated by the medium
                    # albedo
                    zi = 1.0 - 2.0 * rng.uniform(it, pix, dep, Draw.SSS_U)
                    ri = torch.sqrt(torch.clamp_min(1.0 - zi * zi, 0.0))
                    phi = rng.uniform(it, pix, dep, Draw.SSS_V) \
                        * _c32(TWO_PI)
                    o = (ox, oy, oz)
                    dd = (dx, dy, dz)
                    op = [torch.where(scatter_inside,
                                      o[k] + sss_step * dd[k], op[k])
                          for k in range(3)]
                    ndir = [torch.where(scatter_inside, v, ndir[k])
                            for k, v in enumerate((ri * torch.cos(phi),
                                                   ri * torch.sin(phi), zi))]
                thr = [torch.where(scatter_inside, med[k], thr[k])
                       for k in range(3)]
                if has_glass:
                    # the medium changes only at refractions: entering a
                    # geom with sigma > 0 from outside, or leaving from
                    # inside
                    at_surface = cont & ~scatter_inside & took_refract
                    with _needed(lanes=at_surface):
                        entering = at_surface & (row[:, 17] > 0.0) \
                            & h.outside
                    exiting = at_surface & in_med & ~h.outside
                    med_s = torch.where(entering, row[:, 17],
                                        torch.where(exiting, 0.0, med_s))
                    med = [torch.where(entering, row[:, 18 + k],
                                       torch.where(exiting, 1.0, med[k]))
                           for k in range(3)]

            # the lanes of K8's section adjoints (bound.k8_extra): a
            # scattering hit moved (motion), bumped, an imperfect lobe, a
            # refraction, an inside scatter
            def hit_lanes(on):
                return lambda: cont & ~scatter_inside & on

            if time is not None:
                _tally("motion", hit_lanes(True))
            if has_bump:
                _tally("bump", hit_lanes(row[:, 16] > 0.0))
            if has_imperfect:
                _tally("imperfect", hit_lanes(spec & (row[:, 6] > 0.0)))
            if has_glass:
                _tally("refraction", hit_lanes(took_refract))
            if has_sss:
                _tally("sss scatter", scatter_inside)

            if rr_mode and d >= 3:
                # Russian roulette from bounce 3 on, after NEE: survive
                # with the post-bounce throughput's largest channel,
                # boosted by 1/p
                nt = [thr_acc[k] * thr[k] for k in range(3)]
                p_srv = torch.clamp(
                    torch.maximum(nt[0], torch.maximum(nt[1], nt[2])),
                    0.05, 1.0)
                survive = rng.uniform(it, pix, dep, Draw.RR) < p_srv
                cont = cont & survive
                with _needed(lanes=survive):
                    boost = torch.where(survive, torch.reciprocal(p_srv),
                                        1.0)
                    thr = [t * boost for t in thr]

            # the state changes only where the path continues
            with _needed(lanes=cont):
                ox, oy, oz = (torch.where(cont, op[k], v)
                              for k, v in enumerate((ox, oy, oz)))
                dx, dy, dz = (torch.where(cont, ndir[k], v)
                              for k, v in enumerate((dx, dy, dz)))
                thr_acc = [torch.where(cont, thr_acc[k] * thr[k],
                                       thr_acc[k]) for k in range(3)]
        emit_ok = ~took_diffuse | scatter_inside
        live = cont
        if events is not None and has_glass:
            from_refract = took_refract
    out = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, tr=thr_acc[0],
               tg=thr_acc[1], tb=thr_acc[2], rr=rad[0], rg=rad[1], rb=rad[2],
               live=live)
    if nee:
        out["emit_ok"] = emit_ok
    if time is not None:
        out["time"] = time
    if has_sss:
        out.update(med_s=med_s, med_r=med[0], med_g=med[1], med_b=med[2])
    if grad_mats is not None:
        out["grad"] = cnt
    return out


def trace_plain(cam, mats, gmat, geom_types, width, height, depth, it0,
                n_spp, pix0=0, n_local=None, features=NO_FEATURES,
                lights=None, rr=False, tri=None, nodes=None, bvh_meta=(),
                texels=None, tex_geom=(), btex_geom=(), per_sample=False,
                events=None):
    """Plain PyTorch K1 on the device of ``cam``: ``n_spp`` samples of
    the ``n_local`` pixels from ``pix0`` (``n_local`` None: to the end of
    the image; all of it by default) at
    iterations ``it0 .. it0+n_spp-1``, with the scene ``features``
    (``scene_features``), NEE over the ``lights`` table (``pack_lights``;
    None: no NEE), Russian roulette if ``rr``, the triangle meshes of
    ``tri``, ``nodes`` and ``bvh_meta`` (``pack_mesh``; without nodes,
    K3-linear's fold of every triangle) and the image
    textures of ``texels`` (``pack_textures``' words, or the float table
    of ``pack_textures_f32``, which carries a map's graph) under the
    per-geom charts
    ``tex_geom`` and ``btex_geom`` (``tex_statics``): per sample,
    :func:`init_state` and :func:`bounces` over every bounce.

    Returns (rad (n_local, 3) f32 summed over the samples, counts
    (n_spp, depth) int64: live paths entering each bounce of each
    sample, or with ``per_sample`` False their sum over the samples,
    (depth,)).  ``events``, a (depth, len(:data:`K1_EVENTS`)) int64
    tensor on the device, is added K1's event counts of the samples
    (:func:`bounces`)."""
    device = cam.device
    sc = plain_scene(cam, mats, gmat, geom_types, features, lights, rr, tri,
                     nodes, bvh_meta, texels, tex_geom, btex_geom)
    end = width * height if n_local is None else pix0 + n_local
    pixel = torch.arange(pix0, end, dtype=torch.int64, device=device)
    acc = [torch.zeros(pixel.shape, device=device) for _ in range(3)]
    counts = torch.zeros((n_spp, depth), dtype=torch.int64, device=device)
    for s in range(n_spp):
        it = (it0 + s) & 0xFFFFFFFF
        st = bounces(sc, init_state(sc, it, pixel, width, height), it,
                     pixel, 0, depth, counts[s], events=events)
        acc = [a + st[k] for a, k in zip(acc, ("rr", "rg", "rb"))]
    return (torch.stack(acc, dim=-1),
            counts if per_sample else counts.sum(0))


# ----------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ----------------------------------------------------------------------------

_INT_TABLES = {}


def _int_table(rows, device):
    """``rows`` (a static tuple: the geom types, ``bvh_meta``, the
    texture charts) as an int32 tensor on ``device``, made once."""
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


def _check_mesh(tri, nodes, bvh_meta, geom_types, device, cols):
    """The mesh tables must be ``pack_mesh``'s: rows of ``cols`` floats,
    every entry of ``bvh_meta`` a MESH geom whose rows lie inside
    ``nodes`` and ``tri``, its counts exact as float32; without nodes
    (the linear form), entries without nodes."""
    if not bvh_meta:
        if tri is not None or nodes is not None:
            raise ValueError("mesh tables given without bvh_meta")
        return
    _check_table("tri", tri, (tri.shape[0], cols), device)
    n_rows = 0
    if nodes is not None:
        _check_table("nodes", nodes, (nodes.shape[0], 16), device)
        n_rows = nodes.shape[0]
    if tri.data_ptr() % 16 or (nodes is not None and nodes.data_ptr() % 16):
        raise ValueError("tri and nodes must be 16-byte aligned (the "
                         "kernel reads their rows as float4)")
    for g, node_off, n_nodes, tri_off, n_tris in bvh_meta:
        nodes_ok = (node_off == n_nodes == 0 if nodes is None else
                    0 <= node_off and 0 < n_nodes <= 2 ** 24
                    and node_off + n_nodes <= n_rows)
        if not (0 <= g < len(geom_types) and geom_types[g] == T.MESH
                and nodes_ok and 0 <= tri_off and 0 < n_tris <= 2 ** 24
                and tri_off + n_tris <= tri.shape[0]):
            entry = (g, node_off, n_nodes, tri_off, n_tris)
            raise ValueError(f"bad bvh_meta entry {entry} for tables of "
                             f"{n_rows} nodes, {tri.shape[0]} tris")


def _check_textures(texels, tex_geom, btex_geom, n_geoms, device):
    """The texture tables must be ``pack_textures``' and
    ``tex_statics``': an int32 word per texel, and each chart mode ()
    or one (offset, H, W) per geom, ``NO_CHART`` or a map inside the
    table.  A float table (``pack_textures_f32``') is held to its charts
    alone, a texel a row."""
    if not (tex_geom or btex_geom):
        if texels is not None:
            raise ValueError("texels given without tex_geom or btex_geom")
        return
    if texels is None or not texels.is_floating_point() and (
            texels.device != device or texels.dtype != torch.int32 or
            texels.dim() != 1 or not texels.is_contiguous() or
            not 0 < texels.numel() < 2 ** 31):
        raise ValueError(
            f"texels: want a contiguous int32 (n,) tensor on {device}, got "
            f"{None if texels is None else (texels.dtype, texels.shape)}")
    for name, spec in (("tex_geom", tex_geom), ("btex_geom", btex_geom)):
        if spec and len(spec) != n_geoms:
            raise ValueError(f"{name}: {len(spec)} charts for {n_geoms} "
                             f"geoms")
        for off, h, w in spec:
            if (off, h, w) != NO_CHART and not (
                    0 <= off and 0 < h and 0 < w
                    and off + h * w <= len(texels)):
                raise ValueError(
                    f"{name}: chart {(off, h, w)} is not inside a table of "
                    f"{len(texels)} texels")


def ptr(t):
    """The device address of tensor ``t``; 0 for None."""
    return 0 if t is None else t.data_ptr()


class Job(Mapping):
    """A scene's tables on the device of ``cam``, checked once, where the
    job is made (:func:`prepare`, or ``Job(cam, mats, ...)`` of tables a
    caller packed: ``ValueError`` unless they are the ``pack_*``
    functions'); what :func:`trace_k1`, ``span.trace_span``,
    ``matgrad.trace_k7`` and ``vjp.trace_k8`` take first.  A read-only
    mapping of :func:`trace_plain`'s keyword arguments but ``it0`` and
    ``n_spp``.  ``mask``: the kernels' feature mask; ``args``: a launch's
    scene arguments, pointers cam, mats, gmat, types, lights, tri, nodes,
    meta, texels, charts, then n_geoms, n_lights, n_meta, n_texels.  A
    float texel table (:func:`pack_textures_f32`'s) makes a plain-only
    job, which the launchers refuse (:meth:`check_kernel`)."""

    def __init__(self, cam, mats, gmat, geom_types, width, height, depth,
                 features=NO_FEATURES, lights=None, rr=False, tri=None,
                 nodes=None, bvh_meta=(), texels=None, tex_geom=(),
                 btex_geom=()):
        device = cam.device
        geom_types, bvh_meta = tuple(geom_types), tuple(bvh_meta)
        tex_geom, btex_geom = tuple(tex_geom), tuple(btex_geom)
        textured = bool(tex_geom or btex_geom)
        n_geoms = len(geom_types)
        n_lights = 0 if lights is None else lights.shape[0]
        if any(t not in (T.SPHERE, T.CUBE, T.MESH) for t in geom_types):
            raise ValueError(f"unknown geom types in {geom_types}")
        if len(features) != len(FEATURE_NAMES) or not (
                0 < n_geoms and (lights is None or n_lights > 0)):
            raise ValueError(f"bad scene: {n_geoms} geoms, features "
                             f"{features}, {n_lights} lights")
        _check_table("cam", cam, (1, 16), device)
        _check_table("mats", mats, (n_geoms, 24), device)
        _check_table("gmat", gmat, (n_geoms, 40), device)
        if lights is not None:
            _check_table("lights", lights, (n_lights, LIGHT_COLS), device)
        _check_mesh(tri, nodes, bvh_meta, geom_types, device,
                    TRI_TEX_COLS if textured else TRI_COLS)
        _check_textures(texels, tex_geom, btex_geom, n_geoms, device)
        types = _int_table(geom_types, device)
        meta = _int_table(bvh_meta, device) if bvh_meta else None
        # one (albedo offset, H, W, bump offset, H, W) row per geom
        charts = _int_table(tuple(
            a + b for a, b in zip(tex_geom or (NO_CHART,) * n_geoms,
                                  btex_geom or (NO_CHART,) * n_geoms)),
            device) if textured else None
        # set past __setattr__, which keeps a job read-only
        self.__dict__.update(tables=MappingProxyType(dict(
            cam=cam, mats=mats, gmat=gmat, geom_types=geom_types,
            width=width, height=height, depth=depth, features=features,
            lights=lights, rr=rr, tri=tri, nodes=nodes, bvh_meta=bvh_meta,
            texels=texels, tex_geom=tex_geom, btex_geom=btex_geom)),
            mask=feature_mask(features, lights is not None, rr,
                              T.MESH in geom_types, bool(tex_geom),
                              bool(btex_geom),
                              bool(bvh_meta) and nodes is None),
            args=(cam.data_ptr(), mats.data_ptr(), gmat.data_ptr(),
                  types.data_ptr(), ptr(lights), ptr(tri), ptr(nodes),
                  ptr(meta), ptr(texels), ptr(charts), n_geoms, n_lights,
                  len(bvh_meta), 0 if texels is None else len(texels)))

    def __setattr__(self, name, value):
        raise AttributeError(f"a Job is read-only: {name}")

    def __getitem__(self, key):
        return self.tables[key]

    def __iter__(self):
        return iter(self.tables)

    def __len__(self):
        return len(self.tables)

    def check_kernel(self, kernel):
        """Raise ``ValueError`` for a plain-only job: the kernels read
        texels as bytes (``pack_textures``' int32 words), and a float
        table is never converted to one behind the caller's back."""
        texels = self.tables["texels"]
        if texels is not None and texels.is_floating_point():
            raise ValueError(
                f"{kernel} reads texels as bytes (pack_textures' int32 "
                f"words), not a {texels.dtype} table: a float texel table "
                f"(pack_textures_f32) renders on trace_plain, the planes "
                f"engine (--engine planes, engine='planes')")


def launch_error(name, lib, err):
    """Raises for the CUDA error ``err`` of a launch (0: none)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.pt_cuda_error_string(err).decode()})")


def trace_k1(job, it0, n_spp, pix0=0, n_local=None, per_sample=False):
    """K1 on ``job`` (K2 when it has lights, K3 when it has ``bvh_meta``,
    K3-linear when that is without ``nodes``, K4 when it has a texture
    chart): the same computation and result as :func:`trace_plain`.

    For a job on the CPU this is :func:`trace_plain`.  For one on a CUDA
    device it launches the kernel of ``csrc/megakernel.cu`` compiled for
    the job's ``mask`` on the current stream (building it at first use)
    and raises if the build or the launch fails.  With ``per_sample`` the
    counts are each sample's, (n_spp, depth), from the kernel's
    per-sample form (``k1_trace<true>``); else (depth,), summed over the
    samples.  Raises ``ValueError`` for a plain-only job
    (:meth:`Job.check_kernel`), on the CPU too.

    The first call of a profiler's window counts its events into the
    counter ``k1`` (``utils/profiling.counter``, (depth,
    len(:data:`K1_EVENTS`)); on the card K1's counting form adds into it,
    with no copy and no wait).  Every other call, the window's later ones
    too, gets no counter and runs the kernel that counts nothing, so a
    trace times the kernel an untraced call runs."""
    with profiling.span("k1", it0):
        job.check_kernel("K1")
        width, height, depth = job["width"], job["height"], job["depth"]
        device = job["cam"].device
        events = profiling.counter("k1", (depth, len(K1_EVENTS)), device)
        if device.type == "cpu":
            return trace_plain(**job, it0=it0, n_spp=n_spp, pix0=pix0,
                               n_local=n_local, per_sample=per_sample,
                               events=events)
        if device.type != "cuda":
            raise ValueError(f"K1 runs on cuda or cpu tensors, not {device}")
        from . import build

        n_pixels = width * height
        if n_local is None:
            n_local = n_pixels - pix0
        if not (0 < depth and 0 <= n_spp and 0 <= pix0 and 0 < n_local
                and pix0 + n_local <= n_pixels < 2 ** 31):
            raise ValueError(
                f"bad K1 sizes: depth {depth}, {n_spp} spp, pixels "
                f"{pix0}+{n_local} of {n_pixels}")
        rad = torch.empty((n_local, 3), dtype=torch.float32, device=device)
        # the kernel adds into these as unsigned 64-bit integers: per sample
        # (its per-sample build), or summed over the samples
        counts = torch.zeros((n_spp, depth) if per_sample else depth,
                             dtype=torch.int64, device=device)
        lib = build.load_k1(job.mask)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.pt_k1_trace(
                *job.args, width, height, depth, it0 & 0xFFFFFFFF, n_spp,
                pix0, n_local, rad.data_ptr(), counts.data_ptr(),
                ptr(events), int(per_sample), stream)
        launch_error("K1", lib, err)
        LAUNCHES[job.mask] += 1
        return rad, counts


TEXELS = ("u32", "f32")


def prepare(scene, device="cuda", nee=False, rr=False, texels="u32"):
    """Check that K1 can render ``scene`` on ``device`` and return its
    :class:`Job`: the packed tables on ``device``, resident for the whole
    render, and the static facts the kernel is compiled for.  Raises
    ``ValueError`` for a texture off the u8 grid (``pack_textures``) and
    ``RuntimeError`` for a CUDA device without a GPU.

    ``texels="f32"`` packs the maps as :func:`pack_textures_f32`'s float
    table, for :func:`trace_plain` alone (the planes engine): any texel
    value renders, and a map that requires grad keeps its graph; the
    kernels refuse such a job."""
    with profiling.span("prepare"):
        if texels not in TEXELS:
            raise ValueError(
                f"texels must be one of {TEXELS}, not {texels!r}")
        device = resolve_device(device)
        cam, mats, gmat = pack_scene(scene, device)
        lights = pack_lights(scene, device)[0] if nee else None
        tri, nodes, bvh_meta = pack_mesh(scene, device)
        tex_geom, btex_geom = tex_statics(scene)
        width, height = scene.resolution
        return Job(cam=cam, mats=mats, gmat=gmat,
                   geom_types=tuple(scene.geoms.type), width=width,
                   height=height, depth=int(scene.trace_depth),
                   features=scene_features(scene), lights=lights, rr=rr,
                   tri=tri, nodes=nodes, bvh_meta=bvh_meta,
                   texels=(pack_textures_f32 if texels == "f32" else
                           pack_textures)(scene, device)
                   if tex_geom or btex_geom else None,
                   tex_geom=tex_geom, btex_geom=btex_geom)


def pathtrace_batch_cuda(scene, it0, n_iters, device="cuda", nee=False,
                         rr=False):
    """``n_iters`` samples per pixel in one launch, mirroring the
    reference's ``pathtrace_batch_pallas``: returns (accumulated radiance
    (P,3) f32, counts (depth,) int64 summed over the samples) on
    ``device``.  A CPU device runs :func:`trace_plain`; a CUDA device
    runs the kernel and raises when there is no GPU."""
    return trace_k1(prepare(scene, device, nee=nee, rr=rr), it0, n_iters)
