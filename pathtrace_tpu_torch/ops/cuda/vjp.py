"""The in-kernel reverse sweep (K8): host side, plain version, wrapper.

Counterpart of ``_vjp_kernel``, ``_run_vjp`` and ``_render_vjp_jit`` /
``render_vjp_pallas`` of ``pathtrace_tpu/ops/pallas/megakernel.py``
(:3494-3866): the radiance of ``n_spp`` samples and the gradient of
``sum(ct * radiance)`` with respect to every entry of the packed tables
(cam, mats, gmat and, with NEE, lights), chained on the host through the
packing (``megakernel.pack_scene``/``pack_lights`` under autograd) to the
parameters of ``render/diff.split_params``.

The plain version (:func:`k8_plain`) is autograd over
``megakernel.trace_plain``.  The kernel (``k8_vjp`` in
``csrc/megakernel.cu``, built with ``-DPT_VJP=1``) runs, per sample, the
forward sweep through K1's own ``init_state``/``bounce`` (so its radiance
is K1's, bit for bit), keeping each bounce's path state, then walks the
bounces backwards through their adjoints, written by hand (the
reference differentiates its tracer with ``jax.vjp``).  Each block adds
its threads' table gradients into a table in shared memory, then adds
that into the one table in global memory, which a second kernel rounds
to float32.  Every sum is exact (fixed point, integer atomics: csrc's
``fx_add``), so two calls give the same bits.

Meshes with a BVH (masks 512 and 640) run the reference's "carry" form
of ``bvh_grad``: the forward sweep keeps each bounce's winning triangle,
and the reverse sweep differentiates that triangle's hit with the row
detached, so the triangles get no gradient and :func:`render_vjp`
returns ``tri_verts`` None, as the reference does (their gradient is
``render/diff.render_loss_and_grad(engine="planes")``'s).  The plain
version takes the mesh tables as constants.

The K1 sections (glass, imperfect specular, depth of field, motion,
checker, bump, SSS: mask bits 0-6) have their adjoints in the kernel too,
each written by hand beside its forward code; the plain version traces
the scene's sections (``scene_features``) as K1's does.

Scope: every scene the reference's ``render_vjp_pallas`` differentiates:
spheres, cubes and BVH meshes, with any of the sections, with or without
NEE.  A mesh without a BVH and image textures raise
``NotImplementedError`` (the latter naming its ROADMAP item), as the
reference refuses both.
"""

from __future__ import annotations

from collections import Counter

import torch

from ...render import diff as D
from . import megakernel as K

# Launches of K8 by feature mask.
LAUNCHES = Counter()
# the builds the gradients' paths launch: without sections, with NEE, BVH
# meshes; with sections, cornell_glass (7), cornell_checker (24), its bump +
# SSS variant (103), cornell_mesh's glass + checker + motion (537) and bump
# (544) variants, each with and without NEE.  build.load_k8 builds any other
# mask of K8's (csrc's static_assert) at first use.
MASKS = tuple(m | nee for m in (0, K.MESH_BIT, 7, 24, 103, 537, 544)
              for nee in (0, K.NEE_BIT))
MAX_DEPTH = 32
MAX_LIGHTS = 64  # the kernel's exact sums (csrc's kFxMaxLights)
_ITEM = "ROADMAP Queue 1 item 3"


def check_supported(scene, nee=False):
    """Raise ``NotImplementedError`` for a scene outside K8's slice: a
    mesh without a BVH and image textures (as the reference's
    ``render_vjp_pallas`` does; the textures naming their ROADMAP item),
    and depth over ``MAX_DEPTH`` (the stored states)."""
    if scene.mesh.count and not scene.mesh.bvh_meta:
        raise NotImplementedError(
            "render_vjp on a mesh without a BVH: the reverse sweep carries "
            "the BVH walk's winners (scene/bvh.with_bvh builds one; "
            "load_scene does); the linear fold's gradients are "
            "render/diff.render_loss_and_grad(engine='planes', "
            "use_bvh=False)")
    if any(t >= 0 for t in scene.texture_ids) or any(
            t >= 0 for t in scene.bump_texture_ids):
        raise NotImplementedError(
            f"render_vjp on image-textured materials is not ported yet: "
            f"{_ITEM}a' (texel gradients: a float texel path in the plain "
            f"K4)")
    if not 0 < int(scene.trace_depth) <= MAX_DEPTH:
        raise NotImplementedError(
            f"render_vjp keeps every bounce's state: depth 1..{MAX_DEPTH}")


def table_grad_shapes(n_geoms, n_lights):
    """The shapes of the gradient tables: d_cam, d_mats, d_gmat and
    d_lights (None without lights)."""
    return ((1, 16), (n_geoms, 24), (n_geoms, 40),
            (n_lights, K.LIGHT_COLS) if n_lights else None)


def k8_plain(cam, mats, gmat, geom_types, width, height, depth, it0, n_spp,
             lights, ct, tri=None, nodes=None, bvh_meta=(),
             features=K.NO_FEATURES):
    """Plain PyTorch K8 on the device of the tables: autograd over
    :func:`megakernel.trace_plain` with the scene's sections
    ``features`` (``scene_features``), the mesh tables (``pack_mesh``'s)
    constants.  Returns (rad (P,3), [d_cam, d_mats, d_gmat(,
    d_lights)])."""
    leaf = [t.detach().requires_grad_(True) for t in (cam, mats, gmat)]
    if lights is not None:
        leaf.append(lights.detach().requires_grad_(True))
    rad, _ = K.trace_plain(*leaf[:3], geom_types, width, height, depth, it0,
                           n_spp, features=features,
                           lights=leaf[3] if lights is not None else None,
                           tri=tri, nodes=nodes, bvh_meta=bvh_meta)
    torch.autograd.backward(rad, ct)
    return rad.detach(), [t.grad if t.grad is not None
                          else torch.zeros_like(t) for t in leaf]


def trace_k8(cam, mats, gmat, geom_types, width, height, depth, it0, n_spp,
             lights, ct, tri=None, nodes=None, bvh_meta=(),
             features=K.NO_FEATURES):
    """K8 on the packed tables (the sections ``features``; NEE when
    ``lights`` is given; the BVH meshes of ``tri``, ``nodes`` and
    ``bvh_meta``): (rad (P,3), [d_cam (1,16), d_mats (G,24), d_gmat
    (G,40)(, d_lights (L,128))]), the gradients of sum(ct * rad).  For tensors on the CPU
    this is :func:`k8_plain`; on a CUDA device it launches the kernel
    (built at first use) and raises if the build or the launch fails."""
    device = cam.device
    if device.type == "cpu":
        return k8_plain(cam, mats, gmat, geom_types, width, height, depth,
                        it0, n_spp, lights, ct, tri, nodes, bvh_meta,
                        features)
    from . import build

    n_pix = width * height
    n_lights = 0 if lights is None else lights.shape[0]
    if not (0 < depth <= MAX_DEPTH and 0 <= n_spp and 0 < n_pix < 2 ** 31
            and n_lights <= MAX_LIGHTS):
        raise ValueError(f"bad K8 sizes: depth {depth}, {n_spp} spp, "
                         f"{n_pix} pixels, {n_lights} lights")
    if bvh_meta and nodes is None:
        raise ValueError("K8 carries the BVH walk's winners: a mesh without "
                         "nodes (the linear form) has none")
    mask, args = K.kernel_tables(cam, mats, gmat, geom_types, features,
                                 lights, False, tri, nodes, bvh_meta, None,
                                 (), ())
    K._check_table("ct", ct, (n_pix, 3), device)
    shapes = table_grad_shapes(len(geom_types), n_lights)
    n_tab = sum(a * b for a, b in filter(None, shapes))
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    lib = build.load_k8(mask)
    # the exact table the blocks add into, as 64-bit words (csrc's fx_add)
    exact = torch.zeros(lib.pt_fx_words(n_tab), dtype=torch.int64,
                        device=device)
    tab = torch.empty(n_tab, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # cam, mats, gmat, types, lights, tri, nodes, meta and the counts
        # of geoms, lights and meta entries
        err = lib.pt_k8_vjp(
            *args[:8], *args[10:13], width, height, depth, it0 & 0xFFFFFFFF,
            n_spp, ct.data_ptr(), rad.data_ptr(), exact.data_ptr(), stream)
        K.launch_error("K8", lib, err)
        err = lib.pt_fx_round(exact.data_ptr(), n_tab, tab.data_ptr(), stream)
    K.launch_error("K8's rounding", lib, err)
    LAUNCHES[mask] += 1
    grads, off = [], 0
    for shape in filter(None, shapes):
        n = shape[0] * shape[1]
        grads.append(tab[off:off + n].view(shape))
        off += n
    return rad, grads


def render_vjp(scene, ct, it0, n_spp, nee=False, device="cuda",
               plain=False):
    """Radiance and the gradients of ``sum(ct * accumulated radiance)``
    with respect to every parameter of ``render/diff.split_params`` (the
    reference's ``render_vjp_pallas``): the tables are packed on the CPU
    with autograd on and moved to ``device``, K8 gives their gradients,
    and ``torch.autograd.backward`` carries them to the parameters.
    ``ct`` is the (P,3) cotangent image.  Returns (rad (P,3) on
    ``device``, the gradients keyed as ``split_params``); a parameter
    no path depends on gets zeros, and a mesh scene's ``tri_verts`` gets
    None (the triangles are constants of the sweep, as the reference's).
    ``plain`` runs K8's plain version (:func:`k8_plain`) on ``device`` in
    the kernel's place.  Raises ``NotImplementedError`` outside K8's
    slice (:func:`check_supported`)."""
    check_supported(scene, nee)
    device = K.resolve_device(device)
    params = D.requires_grad(D.split_params(scene))
    sc = D.merge_params(scene, params)
    tables = list(K.pack_scene(sc, device))
    lights = K.pack_lights(sc, device)[0] if nee else None
    if lights is not None:
        tables.append(lights)
    tri, nodes, bvh_meta = K.pack_mesh(scene, device)
    ct = torch.as_tensor(ct, dtype=torch.float32).to(device).reshape(
        scene.pixel_count, 3).contiguous()
    width, height = scene.resolution
    rad, d_tables = (k8_plain if plain else trace_k8)(
        *(t.detach() for t in tables[:3]), tuple(scene.geoms.type), width,
        height, int(scene.trace_depth), it0, n_spp,
        lights.detach() if lights is not None else None, ct, tri, nodes,
        bvh_meta, K.scene_features(scene))
    torch.autograd.backward(tables, d_tables)
    grads = D.grads(params)
    if scene.mesh.count:
        grads["tri_verts"] = None
    return rad, grads
