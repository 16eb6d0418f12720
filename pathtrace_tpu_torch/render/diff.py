"""The differentiable parameters of a scene.

Counterpart of ``split_params`` and ``merge_params`` of
``pathtrace_tpu/render/diff.py``: the same dict (``materials``,
``translation``, ``rotation``, ``scale``, ``camera``, ``tri_verts``),
whose leaves here are numpy arrays or float32 tensors.  The gradient
entry points (``ops/cuda/vjp.render_vjp``) turn the leaves into tensors
that require grad (:func:`requires_grad`), pack the merged scene with
autograd on, and read the gradients back in the same dict
(:func:`grads`).

Estimator (the reference's): detached sampling.  Every discrete event
(the lobe taken, the nearest hit, the light face, visibility, the end of
a path) is a function of the random draws and of comparisons, and gets
no gradient; the gradients flow through the continuous factors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import as_f32

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
