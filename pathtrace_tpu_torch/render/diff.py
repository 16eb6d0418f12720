"""Differentiable rendering: the parameters of a scene, and the loss and
its gradients.

Counterpart of ``pathtrace_tpu/render/diff.py``: ``split_params`` and
``merge_params`` give the same dict (``materials``, ``translation``,
``rotation``, ``scale``, ``camera``, ``tri_verts``), whose leaves here
are numpy arrays or float32 tensors.  The autograd entry points
(:func:`render_loss_and_grad`, :func:`render_value_and_pixel_grad`) turn
the leaves into tensors that require grad (:func:`requires_grad`), pack
the merged scene with autograd on, and read the gradients back in the
same dict (:func:`grads`); ``ops/cuda/vjp.render_vjp`` packs with no
graph and gives the same dict through the packing's adjoint, written by
hand (``ops/cuda/pack_adjoint``).

:func:`render_mean` and :func:`render_loss_and_grad` take the
reference's ``engine``: ``"planes"`` is autograd over the megakernel's
plain version (``megakernel.trace_plain``, torch ops on the device, the
counterpart of the reference's planes engine under ``jax.grad``), with
the mesh tables packed differentiably, so ``tri_verts`` gets its
gradient: the BVH walk's winner is found detached and its hit
recomputed (the reference's ``bvh_grad``), or, with ``use_bvh=False``,
the linear fold's (its oracle); its texels are read from a float table
(``megakernel.pack_textures_f32``).  The default ``"wavefront"`` is autograd
over the wavefront integrator (``render/integrator.trace_pixels``, torch
ops on the device), each bounce recomputed in the backward pass when
``remat`` (``torch.utils.checkpoint``), its triangles folded one by one
as the reference's wavefront folds them.
:func:`render_value_and_pixel_grad` differentiates a weighted pixel sum
through it.

Texel gradients: as in the reference, the maps are not a key of
:func:`split_params`; a caller swaps ``scene.textures[t]`` for a float32
tensor that requires grad, and :func:`render_mean` (either engine),
:func:`planes_iteration` and ``render/integrator.pathtrace_iteration``
carry its graph (the reference's ``jax.grad`` over a swapped map).

Estimator (the reference's): detached sampling.  Every discrete event
(the lobe taken, the nearest hit, the light face, visibility, the end of
a path) is a function of the random draws and of comparisons, and gets
no gradient; the gradients flow through the continuous factors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import as_f32

ENGINES = ("wavefront", "planes")

KEYS = ("materials", "translation", "rotation", "scale", "camera",
        "tri_verts")


def split_params(scene):
    """The differentiable parameters of ``scene``, as the reference's
    ``split_params``: a dict of float leaves."""
    return dict(
        materials=scene.materials,
        translation=scene.geoms.translation,
        rotation=scene.geoms.rotation,
        scale=scene.geoms.scale,
        camera=scene.camera,
        tri_verts=scene.mesh.tri_verts,
    )


def merge_params(scene, params):
    """``scene`` with the parameters ``params`` put back."""
    return dataclasses.replace(
        scene,
        materials=params["materials"],
        geoms=dataclasses.replace(
            scene.geoms,
            translation=params["translation"],
            rotation=params["rotation"],
            scale=params["scale"],
        ),
        camera=params["camera"],
        mesh=dataclasses.replace(scene.mesh, tri_verts=params["tri_verts"]),
    )


def map_params(fn, params):
    """``params`` with ``fn`` applied to every float leaf (the arrays of
    the materials and the camera, the transforms, the triangle
    vertices); a None leaf (an extension that is off) stays None."""
    def leaf(x):
        return None if x is None else fn(x)

    def fields(obj):
        return dataclasses.replace(obj, **{
            f.name: leaf(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    return dict(materials=fields(params["materials"]),
                translation=leaf(params["translation"]),
                rotation=leaf(params["rotation"]),
                scale=leaf(params["scale"]),
                camera=fields(params["camera"]),
                tri_verts=leaf(params["tri_verts"]))


def requires_grad(params):
    """``params`` with each leaf a fresh float32 CPU tensor that requires
    grad."""
    return map_params(
        lambda x: as_f32(x).detach().clone().requires_grad_(True), params)


def grads(params):
    """The gradients gathered in the leaves of ``params`` (of
    :func:`requires_grad`), in the same dict; zeros where no gradient
    reached a leaf, as the reference's ``jax.grad`` gives."""
    return map_params(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        params)


def named_leaves(params):
    """[(name, leaf)] of the float leaves of ``params`` that are on, in
    :func:`map_params` order: ``translation``, ``rotation``, ``scale``,
    ``tri_verts`` as they are, ``materials.<field>`` and
    ``camera.<field>``."""
    out = []
    for key in KEYS:
        v = params[key]
        if dataclasses.is_dataclass(v):
            out += [(f"{key}.{f.name}", getattr(v, f.name))
                    for f in dataclasses.fields(v)]
        else:
            out.append((key, v))
    return [(name, v) for name, v in out if v is not None]


def leaves(params):
    """The float leaves of ``params`` that are on, in :func:`map_params`
    order."""
    return [v for _, v in named_leaves(params)]


def _engine_scene(scene, engine, use_bvh):
    """``scene`` as ``engine`` traces it: for the planes engine without
    its BVH unless ``use_bvh`` (the wavefront folds every triangle
    whatever ``use_bvh``, as the reference's does); raises for an engine
    that is not one of :data:`ENGINES`."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")
    if engine == "planes" and not use_bvh and scene.mesh.count:
        from ..scene.bvh import without_bvh

        scene = without_bvh(scene)
    return scene


def render_mean(scene, it0, n_iters, compaction="mask", remat=True,
                nee=False, engine="wavefront", use_bvh=True, device="cuda"):
    """Mean image (P,3) over ``n_iters`` samples from iteration ``it0``,
    differentiable in the leaves of ``scene`` that require grad (the
    reference's ``render_mean``), on ``device``.  ``engine="wavefront"``
    traces with ``render/integrator.trace_pixels``, ``compaction`` ("mask"
    or "sort") choosing how it compacts its rays and ``remat`` whether
    each bounce is recomputed in the backward pass (the same image and
    gradients either way).  ``engine="planes"`` traces with
    ``megakernel.trace_plain`` through the differentiable packing
    (``use_bvh=False``: every triangle folded, K3-linear's plain version)
    and ignores ``compaction`` and ``remat``, as the reference's does."""
    from .. import _check_compaction
    from ..ops.cuda import megakernel as K

    _check_compaction(compaction)
    scene = _engine_scene(scene, engine, use_bvh)
    if engine == "wavefront":
        from .integrator import pathtrace_batch

        rad, _ = pathtrace_batch(scene, it0, n_iters, compaction, remat, nee,
                                 device=device)
    else:
        job = K.prepare(scene, device, nee=nee, texels="f32")
        rad, _ = K.trace_plain(**job, it0=it0, n_spp=n_iters)
    return rad / float(n_iters)


def planes_iteration(scene, it, nee=False, rr=False, device="cuda"):
    """One sample a pixel at iteration ``it`` on the planes engine: the
    megakernel's plain version over the float texel table (the
    reference's ``pathtrace_iteration_planes``), differentiable in the
    leaves and maps of ``scene`` that require grad; (radiance (P,3) f32,
    counts (depth,) int64) on ``device``."""
    from ..ops.cuda import megakernel as K

    job = K.prepare(scene, device, nee=nee, rr=rr, texels="f32")
    return K.trace_plain(**job, it0=it, n_spp=1)


def render_loss_and_grad(scene, target, it0, n_iters, compaction="mask",
                         nee=False, engine="wavefront", use_bvh=True,
                         device="cuda"):
    """The L2 image loss mean((render_mean - target)^2) and its gradients
    with respect to :func:`split_params` (the reference's
    ``render_loss_and_grad``): (loss, a 0-d tensor on ``device``; the
    gradients keyed as ``split_params``, zeros where no path depends on a
    parameter).  :func:`render_mean` says what ``engine`` and
    ``compaction`` choose (the wavefront recomputes each bounce in the
    backward pass, as the reference's does); ``use_bvh=False`` runs the
    planes engine's linear fold, the oracle of the BVH's gradients."""
    scene = _engine_scene(scene, engine, use_bvh)
    params = requires_grad(split_params(scene))
    img = render_mean(merge_params(scene, params), it0, n_iters, compaction,
                      nee=nee, engine=engine, device=device)
    target = torch.as_tensor(target, dtype=torch.float32).to(img.device)
    loss = torch.mean((img - target.reshape(img.shape)) ** 2)
    loss.backward()
    return loss.detach(), grads(params)


def render_value_and_pixel_grad(scene, it0, n_iters, pixel_weights=None,
                                compaction="mask", device="cuda"):
    """The weighted pixel sum of the wavefront's mean image, sum(img x
    ``pixel_weights``) (the plain sum without weights), and its gradients
    with respect to :func:`split_params` (the reference's
    ``render_value_and_pixel_grad``): (value, a 0-d tensor on ``device``;
    the gradients keyed as ``split_params``)."""
    params = requires_grad(split_params(scene))
    img = render_mean(merge_params(scene, params), it0, n_iters, compaction,
                      device=device)
    if pixel_weights is None:
        value = img.sum()
    else:
        w = torch.as_tensor(pixel_weights, dtype=torch.float32)
        value = (img * w.to(img.device)).sum()
    value.backward()
    return value.detach(), grads(params)
