"""Analytic material gradients (K7): host side, plain version, wrapper.

Counterpart of the reference's grad mode of the megakernel
(``pathtrace_tpu/ops/pallas/megakernel.py``: the factor counters of
``_make_tracer``, seeded at :528 and counted at :2054-2093,
``_grad_accumulate`` :2551, the grad branch of ``_run`` :3111-3190 and
``_grads_jit``/``material_grads_pallas`` :3389-3488).

At fixed random draws a path's radiance is a product of one factor per
bounce (a material's color or spec_color, over the probability 1 - p or
p of the lobe taken, p = has_reflective) and the emission it ends on.
So d(radiance)/d(a material's parameter) is the radiance times the
number of times the path met that factor, over the parameter: each path
counts its factors per material (``megakernel.bounces``' ``grad_mats``,
:data:`megakernel.GRAD_COUNTERS`), and :func:`grad_accumulate` folds
``ct * radiance`` with the counts into an (8, M) table: rows 0-2 d/d
color, 3-5 d/d spec_color, 6 d/d emittance, 7 d/d has_reflective.

On the card (:func:`trace_k7`) the kernel is K1's, built with
``-DPT_GRAD=1``, on K1's lane schedule: the shared ``bounce`` also
records each bounce's factor (the geom and which factor) in a per-path
list; the lane folds its path's terms into its block's table the step
the path ends and starts its next sample. The block adds its table into
the one table in global memory at the end of each chunk of samples,
after at most :func:`k7_flush_paths` paths. Every sum is exact (fixed
point, integer atomics: csrc's ``fx_add``) and rounded to float32 once,
so the bits do not depend on the order of the adds: two calls, and any
chunking, give the same bits. The radiance is K1's, bit for bit.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import megakernel as K

# Launches of K7 by K1 feature mask.
LAUNCHES = Counter()
GRAD_ROWS = 8
MAX_MATERIALS = 128
MAX_DEPTH = 63
EPS = 1e-8
# A 32-bit limb of the exact table holds any sum of fewer than 2^19 of its
# 12-bit digits (csrc's fx_add: 2^19 x (2^12 - 1) < 2^31).
LIMB_DIGITS = 2 ** 19


def k7_flush_paths(depth):
    """The paths a block of K7 may fold between two flushes of its table
    at ``depth``: a path adds at most one term an event to an entry, one
    digit a limb, and meets at most ``depth`` events, so every limb stays
    under :data:`LIMB_DIGITS` digits while paths x depth < 2^19."""
    if not 0 < depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} is not in 1 .. {MAX_DEPTH}")
    return (LIMB_DIGITS - 1) // depth


def check_supported(scene, nee=False, rr=False):
    """Raise ``NotImplementedError`` where the reference's
    ``material_grads_pallas`` does (:3451-3481): the per-path factor
    count assumes each bounce's throughput is its material's color or
    spec_color over its lobe's probability, which NEE, Russian roulette,
    checker albedo, subsurface media and image textures break; at most
    128 materials and depth 63, the reference's limits."""
    m = scene.materials
    why = None
    if nee:
        why = "NEE (the direct term is not a product of the path's factors)"
    elif rr:
        why = "Russian roulette (the 1/p boost is not a material factor)"
    elif m.checker_scale is not None:
        why = "CHECKER materials"
    elif m.sss_sigma is not None:
        why = "SSS materials"
    elif any(t >= 0 for t in scene.texture_ids) or any(
            t >= 0 for t in scene.bump_texture_ids):
        why = "image-textured materials"
    elif m.count > MAX_MATERIALS:
        why = f"more than {MAX_MATERIALS} materials"
    elif int(scene.trace_depth) > MAX_DEPTH:
        why = f"depth over {MAX_DEPTH}"
    if why is not None:
        raise NotImplementedError(
            f"material_grads does not support {why}, as the reference's "
            f"material_grads_pallas does not; use render_vjp")


def material_table(scene, device="cuda"):
    """(M, 8) float32: each material's color (3), spec_color (3),
    emittance and has_reflective (the reference's ``mtab``)."""
    m = scene.materials

    def col(x):
        return np.asarray(x, np.float32).reshape(m.count, -1)

    tab = np.concatenate([col(m.color), col(m.spec_color), col(m.emittance),
                          col(m.has_reflective)], axis=1)
    return torch.as_tensor(tab).to(K.resolve_device(device))


def grad_accumulate(rad, cnt, ct, mtab):
    """The (8, M) table of one sample (the reference's
    ``_grad_accumulate``): ``rad`` (N,3) the paths' radiance, ``cnt``
    (5, M, N) their factor counts, ``ct`` (N,3) the cotangent, ``mtab``
    (M, 8).  Each term is the reference's: w * n / max(x, eps) where the
    parameter x > eps, else 0, with w = ct * rad; has_reflective's is
    w_sum * (n_(1-p) / (1 - p) - n_p / p) at p = clip(x, 0, 1)."""
    w = (ct * rad).T                               # (3, N)
    wsum = w[0] + w[1] + w[2]
    n = cnt.to(torch.float32)
    eps = torch.tensor(EPS, device=rad.device)

    def term(x, count, wv):
        # x (M, C), count (M, N), wv (C, N) -> (C, M)
        x = x.T[:, :, None]
        val = (wv[:, None, :] * count[None]) / torch.maximum(x, eps)
        return torch.where(x > eps, val, 0.0).sum(-1)

    pm = torch.clamp(mtab[:, 7], 0.0, 1.0)[:, None]
    refl = (-torch.where(pm > eps, n[3] / torch.maximum(pm, eps), 0.0)
            + torch.where(1.0 - pm > eps,
                          n[4] / torch.maximum(1.0 - pm, eps), 0.0))
    return torch.cat([
        term(mtab[:, 0:3], n[0], w),
        term(mtab[:, 3:6], n[1], w),
        term(mtab[:, 6:7], n[2], wsum[None]),
        (wsum[None] * refl).sum(-1)[None],
    ])


def k7_plain(job, mtab, mat_of_geom, ct, it0, n_spp):
    """Plain PyTorch K7 on the device of the tables: (rad (P,3) summed
    over the samples, counts (depth,), the (8, M) table summed over the
    samples)."""
    sc = K.plain_scene(**job)
    width, height, depth = job["width"], job["height"], job["depth"]
    device = job["cam"].device
    pixel = torch.arange(width * height, dtype=torch.int64, device=device)
    rad = torch.zeros((pixel.shape[0], 3), device=device)
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    gtab = torch.zeros((GRAD_ROWS, mtab.shape[0]), device=device)
    for s in range(n_spp):
        it = (it0 + s) & 0xFFFFFFFF
        st = K.bounces(sc, K.init_state(sc, it, pixel, width, height), it,
                       pixel, 0, depth, counts,
                       grad_mats=(mtab.shape[0], mat_of_geom))
        r = torch.stack([st["rr"], st["rg"], st["rb"]], dim=-1)
        rad = rad + r
        gtab = gtab + grad_accumulate(r, st["grad"], ct, mtab)
    return rad, counts, gtab


def trace_k7(job, mtab, mat_of_geom, ct, it0, n_spp, flush_paths=None):
    """K7 on the tables of ``job`` (``megakernel.prepare``'s, without
    NEE, RR or textures): (rad (P,3), counts (depth,), the (8, M)
    gradient table of sum(ct * rad)).  For tensors on the CPU this is
    :func:`k7_plain`; on a CUDA device it launches the kernel (built at
    first use) and raises if the build or the launch fails.  A block
    flushes its table after at most ``flush_paths`` paths (default
    :func:`k7_flush_paths`; fewer flush more often, to the same bits; the
    launch fails below one sample of a block's pool).  Raises
    ``ValueError`` for a plain-only job (``megakernel.Job.check_kernel``),
    on the CPU too."""
    job.check_kernel("K7")
    device = job["cam"].device
    if device.type == "cpu":
        return k7_plain(job, mtab, mat_of_geom, ct, it0, n_spp)
    from . import build

    width, height, depth = job["width"], job["height"], job["depth"]
    n_pix = width * height
    n_mats = mtab.shape[0]
    if not (0 < depth <= MAX_DEPTH and 0 < n_mats <= MAX_MATERIALS
            and 0 <= n_spp and len(mat_of_geom) == len(job["geom_types"])
            and all(0 <= m < n_mats for m in mat_of_geom)):
        raise ValueError(f"bad K7 sizes: depth {depth}, {n_mats} "
                         f"materials, geoms' materials {mat_of_geom}")
    if job["lights"] is not None or job["rr"] or job["texels"] is not None:
        raise ValueError("K7 takes no lights, RR or textures")
    if flush_paths is None:
        flush_paths = k7_flush_paths(depth)
    if not 0 < flush_paths <= k7_flush_paths(depth):
        raise ValueError(f"K7 flushes after 1 .. {k7_flush_paths(depth)} "
                         f"paths at depth {depth}, not {flush_paths}")
    K._check_table("mtab", mtab, (n_mats, GRAD_ROWS), device)
    K._check_table("ct", ct, (n_pix, 3), device)
    mat_t = K._int_table(tuple(mat_of_geom), device)
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    counts = torch.zeros(depth, dtype=torch.int64, device=device)
    lib = build.load_k7(job.mask)
    # the exact table the blocks add into, as 64-bit words (csrc's fx_add)
    exact = torch.zeros(lib.pt_fx_words(GRAD_ROWS * n_mats),
                        dtype=torch.int64, device=device)
    gtab = torch.empty((GRAD_ROWS, n_mats), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_k7_grads(
            *job.args, width, height, depth, it0 & 0xFFFFFFFF, n_spp,
            flush_paths, mtab.data_ptr(), mat_t.data_ptr(), n_mats,
            ct.data_ptr(), rad.data_ptr(), counts.data_ptr(),
            exact.data_ptr(), stream)
        K.launch_error("K7", lib, err)
        err = lib.pt_fx_round(exact.data_ptr(), GRAD_ROWS * n_mats,
                              gtab.data_ptr(), stream)
    K.launch_error("K7's rounding", lib, err)
    LAUNCHES[job.mask] += 1
    return rad, counts, gtab


def material_grads(scene, ct, it0, n_spp, device="cuda", nee=False,
                   rr=False, plain=False):
    """Analytic gradients of ``sum(ct * radiance)`` with respect to each
    material's color, spec_color, emittance and has_reflective, from
    ``n_spp`` samples at iterations ``it0 ..`` (the reference's
    ``material_grads_pallas``).  ``ct`` is the (P,3) cotangent image.
    Returns (accumulated radiance (P,3), {color (M,3), spec_color (M,3),
    emittance (M,), has_reflective (M,)}) on ``device``.  Estimator: the
    lobe choices are detached, and a parameter at zero gets zero
    gradient (the reference's caveats).  ``plain`` runs K7's plain
    version (:func:`k7_plain`) on ``device`` in the kernel's place.
    Raises ``NotImplementedError`` where the reference does
    (:func:`check_supported`)."""
    check_supported(scene, nee, rr)
    job = K.prepare(scene, device)
    device = job["cam"].device
    mtab = material_table(scene, device)
    ct = torch.as_tensor(ct, dtype=torch.float32).to(device).reshape(
        scene.pixel_count, 3).contiguous()
    mat_of_geom = tuple(int(x) for x in np.asarray(scene.geoms.material_id))
    rad, _, gtab = (k7_plain if plain else trace_k7)(job, mtab, mat_of_geom,
                                                     ct, it0, n_spp)
    return rad, dict(color=gtab[0:3].T, spec_color=gtab[3:6].T,
                     emittance=gtab[6], has_reflective=gtab[7])

