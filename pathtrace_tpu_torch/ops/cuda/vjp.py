"""The in-kernel reverse sweep (K8): host side, plain version, wrapper.

Counterpart of ``_vjp_kernel``, ``_run_vjp`` and ``_render_vjp_jit`` /
``render_vjp_pallas`` of ``pathtrace_tpu/ops/pallas/megakernel.py``
(:3494-3866): the radiance of ``n_spp`` samples and the gradient of
``sum(ct * radiance)`` with respect to every entry of the packed tables
(cam, mats, gmat and, with NEE, lights), chained on the host through the
packing's adjoint, written by hand (``pack_adjoint.pack_adjoint``: the
tables are packed with no autograd graph), to the parameters of
``render/diff.split_params``.

The plain version (:func:`k8_plain`) is autograd over
``megakernel.trace_plain``.  On the card (:func:`trace_k8`) K8 is two
kernels of ``csrc/megakernel.cu`` built with ``-DPT_VJP=1``, joined by a
tape in device memory, both on K1's lane schedule (a lane whose path ends
starts its pixel's next sample, or takes its block's next pixel, at
once).  ``k8_vjp_fwd`` runs the forward sweeps through K1's own
``init_state``/``bounce`` (so its radiance is K1's, bit for bit) and
writes each live bounce's path state and what it found to the tape;
``k8_vjp_rev`` walks each path's live bounces backwards through their
adjoints, written by hand (the reference differentiates its tracer with
``jax.vjp``), then raygen's.  The tape has a fixed ceiling,
:data:`TAPE_BYTES`: :func:`k8_plan` cuts a call into chunks of samples
and, where one sample of the image passes it, ranges of pixels, and the
pair runs once a chunk.  Each block adds its threads' table gradients
into a table in shared memory, then adds that into the one table in
global memory before any limb of it could overflow (csrc's
``k8_flush_paths``), which a third kernel rounds to float32.  Every sum
is exact (fixed point, integer atomics: csrc's ``fx_add``), so two
calls, and any chunking, give the same bits.

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

from ...utils import profiling
from . import megakernel as K
from .pack_adjoint import pack_adjoint

# Launches of K8's pair of kernels by feature mask, one a chunk of the plan.
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
# The tape's ceiling: the device memory a call of K8 keeps from its forward
# sweep for its reverse one (the records, each path's count of live bounces
# and each pixel's carried camera sums), one chunk at a time.
TAPE_BYTES = 2 ** 31
# K8's lane counters (``utils/profiling.counter("k8")``): lane-steps the
# warps issued and those that ran a live bounce, forward then reverse.
K8_LANES = ("fwd.issued", "fwd.live", "rev.issued", "rev.live")


def check_supported(scene, nee=False):
    """Raise ``NotImplementedError`` for a scene outside K8's slice: a
    mesh without a BVH and image textures (as the reference's
    ``render_vjp_pallas`` does; the textures naming the planes engine),
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
            "render_vjp does not trace image-textured materials, as the "
            "reference's render_vjp_pallas does not (a texel's gradient is "
            "a scatter-add): they ride "
            "render/diff.render_loss_and_grad(engine='planes'), which "
            "gives texel gradients through render_mean")
    if not 0 < int(scene.trace_depth) <= MAX_DEPTH:
        raise NotImplementedError(
            f"render_vjp keeps every bounce's state: depth 1..{MAX_DEPTH}")


def k8_plan(n_pix, n_spp, depth, record, carry, budget):
    """The chunks of a call of K8, as (first pixel, pixels, first sample,
    end sample): a launch of the pair each, in this order.  A chunk's tape
    holds its pixels x samples paths of ``depth`` records of ``record``
    bytes and a count byte each, and a pixel's carried camera sums of
    ``carry`` bytes (the build's ``pt_k8_record_bytes`` and
    ``pt_k8_carry_bytes``), within ``budget`` bytes.  The whole image
    a chunk, as many samples as fit, in chunks of even size; where one
    sample of the image does not fit, ranges of pixels of even size, one
    sample a chunk, each range's samples in order before the next range
    (the carried sums are a range's).  Every (pixel, sample) is in one
    chunk, each pixel's samples in order.  No chunk for 0 samples.
    Raises ``ValueError`` for sizes :func:`trace_k8` refuses and for a
    budget below one path's tape."""
    if not (0 < depth <= MAX_DEPTH and 0 <= n_spp and 0 < n_pix < 2 ** 31
            and record > 0 and carry >= 0):
        raise ValueError(f"bad K8 sizes: depth {depth}, {n_spp} spp, "
                         f"{n_pix} pixels, records of {record} bytes, "
                         f"carried sums of {carry}")
    path = depth * record + 1
    if n_spp == 0:
        return []
    if n_pix * (path + carry) <= budget:
        most = min(n_spp, (budget // n_pix - carry) // path)
        n_chunks = -(-n_spp // most)
        n_s = -(-n_spp // n_chunks)
        return [(0, n_pix, s0, min(n_spp, s0 + n_s))
                for s0 in range(0, n_spp, n_s)]
    most = budget // (path + carry)
    if most < 1:
        raise ValueError(f"K8's tape budget of {budget} bytes holds no "
                         f"path of depth {depth} ({path + carry} bytes)")
    n_ranges = -(-n_pix // most)
    n_px = -(-n_pix // n_ranges)
    return [(p0, min(n_px, n_pix - p0), s0, s0 + 1)
            for p0 in range(0, n_pix, n_px) for s0 in range(n_spp)]


def table_grad_shapes(job):
    """The shapes of the gradient tables: those of the job's cam, mats,
    gmat and lights (None without lights)."""
    return tuple(None if job[k] is None else tuple(job[k].shape)
                 for k in ("cam", "mats", "gmat", "lights"))


def k8_plain(job, it0, n_spp, ct):
    """Plain PyTorch K8 on the device of the job: autograd over
    :func:`megakernel.trace_plain` of ``job``, the mesh tables
    constants.  Returns (rad (P,3), [d_cam, d_mats, d_gmat(,
    d_lights)])."""
    leaf = {k: job[k].detach().requires_grad_(True)
            for k in ("cam", "mats", "gmat", "lights") if job[k] is not None}
    rad, _ = K.trace_plain(**dict(job, **leaf), it0=it0, n_spp=n_spp)
    torch.autograd.backward(rad, ct)
    return rad.detach(), [t.grad if t.grad is not None
                          else torch.zeros_like(t) for t in leaf.values()]


def split_tables(tab, shapes):
    """The flat table ``tab`` (a tensor or an array) cut into the tables
    of ``shapes`` (:func:`table_grad_shapes`), views of it."""
    out, off = [], 0
    for shape in filter(None, shapes):
        n = shape[0] * shape[1]
        out.append(tab[off:off + n].reshape(shape))
        off += n
    return out


def _joined(tables):
    return torch.cat([t.reshape(-1) for t in tables])


def _on_device(tables, device):
    """``tables`` (CPU tensors, or None) on ``device``: views of one
    buffer, filled by one copy from pinned memory that does not wait for
    the device (a copy from pageable memory waits for the work queued
    before it, a step's render among it)."""
    have = [t for t in tables if t is not None]
    flat = _joined(have)
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    moved = iter(split_tables(flat, [tuple(t.shape) for t in have]))
    return [None if t is None else next(moved) for t in tables]


def trace_k8(job, it0, n_spp, ct):
    """K8 on ``job`` (its sections; NEE when it has lights; its BVH
    meshes): (rad (P,3), [d_cam (1,16), d_mats (G,24), d_gmat (G,40)(,
    d_lights (L,128))]), the gradients of sum(ct * rad): :func:`k8_flat`'s
    table cut into its tables."""
    rad, tab = k8_flat(job, it0, n_spp, ct)
    return rad, split_tables(tab, table_grad_shapes(job))


def k8_flat(job, it0, n_spp, ct):
    """K8 on ``job`` as :func:`trace_k8`, the gradient tables flattened
    and joined in one (cam, mats, gmat(, lights)), on the job's device.
    For a job on the CPU this is :func:`k8_plain`; on a CUDA device it
    launches the pair of kernels once a chunk of :func:`k8_plan` under
    :data:`TAPE_BYTES` (built at first use) and raises if the build or a
    launch fails.  Raises ``ValueError`` for a plain-only job
    (``megakernel.Job.check_kernel``), on the CPU too.

    The first call of a profiler's window counts K8's lane-steps into the
    counter ``k8`` (``utils/profiling.counter``, :data:`K8_LANES`), in the
    kernels' counting forms; every other call runs the forms that count
    nothing."""
    job.check_kernel("K8")
    device = job["cam"].device
    if device.type == "cpu":
        rad, tables = k8_plain(job, it0, n_spp, ct)
        return rad, _joined(tables)
    from . import build

    width, height, depth = job["width"], job["height"], job["depth"]
    n_pix = width * height
    n_lights = 0 if job["lights"] is None else job["lights"].shape[0]
    if n_lights > MAX_LIGHTS or job["rr"] or job["texels"] is not None:
        raise ValueError(f"K8 takes at most {MAX_LIGHTS} lights and no RR "
                         f"or textures, not {n_lights} lights, rr {job['rr']}")
    if job["bvh_meta"] and job["nodes"] is None:
        raise ValueError("K8 carries the BVH walk's winners: a mesh without "
                         "nodes (the linear form) has none")
    K._check_table("ct", ct, (n_pix, 3), device)
    shapes = table_grad_shapes(job)
    n_tab = sum(a * b for a, b in filter(None, shapes))
    lib = build.load_k8(job.mask)
    record, carry_bytes = lib.pt_k8_record_bytes(), lib.pt_k8_carry_bytes()
    plan = k8_plan(n_pix, n_spp, depth, record, carry_bytes, TAPE_BYTES)
    lanes = profiling.counter("k8", (len(K8_LANES),), device)
    rad = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    # the exact table the blocks add into, as 64-bit words (csrc's fx_add)
    exact = torch.zeros(lib.pt_fx_words(n_tab), dtype=torch.int64,
                        device=device)
    tab = torch.empty(n_tab, dtype=torch.float32, device=device)
    # a chunk's scratch, sized for the largest
    n_px = max((c[1] for c in plan), default=0)
    n_s = max((c[3] - c[2] for c in plan), default=0)
    tape = torch.empty(n_px * n_s * depth * record, dtype=torch.uint8,
                       device=device)
    n_live = torch.empty(n_px * n_s, dtype=torch.uint8, device=device)
    carry = torch.empty(n_px * carry_bytes // 4, dtype=torch.float32,
                        device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for px0, n, s0, s1 in plan:
            # cam, mats, gmat, types, lights, tri, nodes, meta and the
            # counts of geoms, lights and meta entries
            err = lib.pt_k8_vjp(
                *job.args[:8], *job.args[10:13], width, height, depth,
                it0 & 0xFFFFFFFF, n_spp, px0, n, s0, s1, ct.data_ptr(),
                rad.data_ptr(), tape.data_ptr(), n_live.data_ptr(), carry.data_ptr(), exact.data_ptr(),
                K.ptr(lanes), stream)
            K.launch_error("K8", lib, err)
            LAUNCHES[job.mask] += 1
        err = lib.pt_fx_round(exact.data_ptr(), n_tab, tab.data_ptr(), stream)
    K.launch_error("K8's rounding", lib, err)
    return rad, tab


def render_vjp(scene, ct, it0, n_spp, nee=False, device="cuda",
               plain=False):
    """Radiance and the gradients of ``sum(ct * accumulated radiance)``
    with respect to every parameter of ``render/diff.split_params`` (the
    reference's ``render_vjp_pallas``): the tables are packed on the CPU,
    with no autograd graph, and moved to ``device`` in one copy that
    does not wait for the work queued there, K8 gives their gradients,
    and the packing's adjoint written by hand
    (``pack_adjoint.pack_adjoint``) carries them, copied to the host in
    one table, to the parameters.  ``ct`` is the (P,3) cotangent image.
    Returns (rad (P,3) on ``device``, the gradients keyed as
    ``split_params``, float32 CPU tensors); a parameter no path depends
    on gets zeros, and a mesh scene's ``tri_verts`` gets None (the
    triangles are constants of the sweep, as the reference's).
    ``plain`` runs K8's plain version (:func:`k8_plain`) on ``device`` in
    the kernel's place.  Raises ``NotImplementedError`` outside K8's
    slice (:func:`check_supported`)."""
    with profiling.span("vjp", it0):
        with profiling.span("vjp.pack"):
            check_supported(scene, nee)
            device = K.resolve_device(device)
            with torch.no_grad():
                tables = [*K.pack_scene(scene, "cpu"),
                          K.pack_lights(scene, "cpu")[0] if nee else None]
            tri, nodes, bvh_meta = K.pack_mesh(scene, "cpu")
            cam, mats, gmat, lights, tri, nodes = _on_device(
                tables + [tri, nodes], device)
            width, height = scene.resolution
            job = K.Job(cam, mats, gmat, tuple(scene.geoms.type), width,
                        height, int(scene.trace_depth),
                        K.scene_features(scene), lights, tri=tri,
                        nodes=nodes, bvh_meta=bvh_meta)
            ct = torch.as_tensor(ct, dtype=torch.float32).to(device).reshape(
                scene.pixel_count, 3).contiguous()
        if plain:
            rad, tab = k8_plain(job, it0, n_spp, ct)
            tab = _joined(tab)
        else:
            rad, tab = k8_flat(job, it0, n_spp, ct)
        # the chain's copy to the host waits for K8: wait here, so the
        # chain's span holds none of it
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        with profiling.span("vjp.chain"):
            tables = split_tables(tab.cpu().numpy(), table_grad_shapes(job))
            return rad, pack_adjoint(scene, *tables)
