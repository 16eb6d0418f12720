"""Inverse rendering: recover a light's position, a wall's albedo or a
mesh's vertices from a target render.

    python -m pathtrace_tpu_torch.render.inverse light|albedo|mesh [...]

(the flags of the reference's ``examples/inverse_*.py``; ``--device cpu``
runs the plain versions).

:func:`inverse_light` is the loop of the reference's
``examples/inverse_light.py``: render the
target, move the light by ``offset``, then per step render the current
scene with NEE (K1), take the cotangent of the image's mean squared
error, and step the light's translation along the gradient that the
reverse sweep (K8, ``ops/cuda/vjp.render_vjp``) gives, the step capped
at ``max_step`` world units.  Geometry gradients need NEE: at fixed
random draws, pure BSDF sampling is piecewise constant in the
transforms, and NEE's cos cos' / r^2 term carries the continuous
dependence.

:func:`inverse_albedo` is the loop of ``examples/inverse_rendering.py``:
the target on K1, the red wall's albedo forgotten to grey, and per step a
render on K1 and the albedo's gradient from the material-gradient kernel
K7 (``ops/cuda/matgrad.material_grads``).  :func:`inverse_mesh` is the
loop of ``examples/inverse_mesh.py``: the grid plane of
cornell_bumpmesh with its vertices moved out of plane, stepped back
along the normalised ``tri_verts`` gradient of the image loss on the
planes engine (``render/diff.render_loss_and_grad(engine="planes",
use_bvh=False)``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..ops.cuda import megakernel as K
from ..ops.cuda import vjp
from ..ops.cuda.matgrad import material_grads
from . import diff


def _with_translation(scene, tr):
    return dataclasses.replace(
        scene, geoms=dataclasses.replace(scene.geoms, translation=tr))


def inverse_light(scene, steps=40, spp=8, light=0, offset=(1.5, 0.0, 1.0),
                  lr=150.0, max_step=0.3, device="cuda", callback=None,
                  plain=False):
    """``steps`` gradient steps on the translation of geom ``light``,
    from its true position moved by ``offset``, towards the render of
    ``scene`` (``spp`` samples, NEE).  ``callback(step, position,
    error)`` runs after each step; ``plain`` takes the gradients from
    K8's plain version.  Returns the max-norm position errors of the
    start and of each step, a list of ``steps + 1`` floats."""
    true_pos = np.asarray(scene.geoms.translation, np.float32)[light].copy()
    n_pix = scene.pixel_count
    target = K.pathtrace_batch_cuda(scene, 1, spp, device=device,
                                    nee=True)[0] / spp
    tr = np.asarray(scene.geoms.translation, np.float32).copy()
    tr[light] = tr[light] + np.asarray(offset, np.float32)
    cur = _with_translation(scene, tr)
    errors = [float(np.abs(tr[light] - true_pos).max())]
    for step in range(steps):
        img = K.pathtrace_batch_cuda(cur, 1, spp, device=device,
                                     nee=True)[0] / spp
        # d MSE / d (the sum of the samples' radiance): through /spp and
        # the mean over the image
        ct = (img - target) * (2.0 / (n_pix * 3 * spp))
        _, g = vjp.render_vjp(cur, ct, 1, spp, nee=True, device=device,
                              plain=plain)
        upd = lr * g["translation"][light].to(torch.float64).numpy()
        norm = np.linalg.norm(upd)
        if norm > max_step:
            upd = upd * (max_step / norm)
        tr = tr.copy()
        tr[light] = (tr[light] - upd).astype(np.float32)
        cur = _with_translation(cur, tr)
        errors.append(float(np.abs(tr[light] - true_pos).max()))
        if callback is not None:
            callback(step, tr[light].copy(), errors[-1])
    return errors


# the wall whose albedo inverse_albedo recovers: cornell's red wall
ALBEDO_MATERIAL = 2
# inverse_albedo's step on the albedo, d MSE / d albedo carrying 1/P
# through the cotangent: the reference's 2e-7 x 800^2, so that a stamp
# size moves at the full size's rate
ALBEDO_LR = 0.128


def inverse_albedo(scene, steps=30, spp=50, device="cuda", callback=None):
    """``steps`` gradient steps on the albedo of material
    ``ALBEDO_MATERIAL`` (cornell's red wall), from grey, towards the
    render of ``scene`` (``spp`` samples on K1): per step a render on K1,
    the cotangent of the image's mean squared error, the albedo's
    gradient from K7, a step of ``ALBEDO_LR`` clipped to [0.02, 1].
    ``callback(step, albedo, error)`` runs after each step.  Returns the
    max-norm albedo errors (at the start, at the end)."""
    n_pix = scene.pixel_count
    target = K.pathtrace_batch_cuda(scene, 1, spp, device=device)[0] / spp
    m = scene.materials
    true = np.asarray(m.color, np.float32)[ALBEDO_MATERIAL].copy()
    col = np.asarray(m.color, np.float32).copy()
    col[ALBEDO_MATERIAL] = 0.5  # forget the wall
    cur = dataclasses.replace(scene, materials=dataclasses.replace(
        m, color=col))
    err0 = float(np.abs(col[ALBEDO_MATERIAL] - true).max())
    for step in range(steps):
        img = K.pathtrace_batch_cuda(cur, 1, spp, device=device)[0] / spp
        ct = (img - target) * (2.0 / n_pix)  # d MSE / d img
        _, g = material_grads(cur, ct, 1, spp, device=device)
        col = col.copy()
        col[ALBEDO_MATERIAL] = np.clip(
            col[ALBEDO_MATERIAL]
            - ALBEDO_LR * g["color"][ALBEDO_MATERIAL].cpu().numpy(),
            0.02, 1.0)
        cur = dataclasses.replace(cur, materials=dataclasses.replace(
            cur.materials, color=col))
        if callback is not None:
            callback(step, col[ALBEDO_MATERIAL].copy(),
                     float(np.abs(col[ALBEDO_MATERIAL] - true).max()))
    return err0, float(np.abs(col[ALBEDO_MATERIAL] - true).max())


def inverse_mesh(scene, steps=40, spp=4, device="cuda", callback=None):
    """``steps`` steps on the triangle vertices of ``scene`` (the
    reference's example: cornell_bumpmesh at 48x48 d3), its BUMPTEX
    strength zeroed, from vertices moved out of plane (object-space y,
    0.05 x ``RandomState(7)`` normals) towards the render of the true
    ones (``spp`` samples, NEE, the planes engine): per step the image
    loss's ``tri_verts`` gradient on the planes engine, and a step of
    0.02 x 0.95^step along it divided by its largest entry.  Every
    triangle is folded (``use_bvh=False``): the moved vertices leave the
    boxes of the BVH built for the loaded mesh, whose walk would miss
    them (the reference's example walks that BVH all the same).
    ``callback(step, loss, rms vertex error)`` runs after each step.
    Returns the image losses (at the start, at the end)."""
    m = scene.materials
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        m, bumptex_strength=np.zeros_like(np.asarray(m.bumptex_strength))))
    tv_true = torch.as_tensor(np.asarray(scene.mesh.tri_verts, np.float32))
    with torch.no_grad():
        target = diff.render_mean(scene, 1, spp, nee=True, engine="planes",
                                  use_bvh=False, device=device)
    rs = np.random.RandomState(7)
    tv = tv_true.clone()
    tv[:, :, 1] += torch.as_tensor(
        0.05 * rs.randn(tv.shape[0], 3).astype(np.float32))

    def loss_and_grad(tv):
        sc = dataclasses.replace(scene, mesh=dataclasses.replace(
            scene.mesh, tri_verts=tv))
        return diff.render_loss_and_grad(sc, target, 1, spp, nee=True,
                                         engine="planes", use_bvh=False,
                                         device=device)

    loss0 = None
    for step in range(steps):
        loss, g = loss_and_grad(tv)
        if loss0 is None:
            loss0 = float(loss)
        gv = g["tri_verts"]
        # a normalised step with decay: the vertices' gradients are tiny
        # in absolute scale, so a fixed step along their direction
        # converges far faster than plain gradient descent
        tv = tv - (0.02 * 0.95 ** step) * gv / (gv.abs().max() + 1e-12)
        if callback is not None:
            callback(step, float(loss),
                     float(torch.sqrt(((tv - tv_true) ** 2).mean())))
    return loss0, float(loss_and_grad(tv)[0])


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pathtrace_tpu_torch.render.inverse",
        description="inverse rendering: a light's position (light), a "
                    "wall's albedo (albedo) or a mesh's vertices (mesh)")
    p.add_argument("what", choices=("light", "albedo", "mesh"))
    p.add_argument("--steps", type=int, default=None,
                   help="gradient steps (light 40, albedo 30, mesh 40)")
    p.add_argument("--res", type=int, default=None,
                   help="square resolution (light 200, albedo 800, mesh 48)")
    p.add_argument("--spp", type=int, default=None,
                   help="samples a render (light 8, albedo 50, mesh 4)")
    p.add_argument("--depth", type=int, default=0,
                   help="trace depth (0: the scene's; mesh: 3)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    steps, res, spp, name = {
        "light": (40, 200, 8, "cornell"), "albedo": (30, 800, 50, "cornell"),
        "mesh": (40, 48, 4, "cornell_bumpmesh")}[args.what]
    steps = args.steps if args.steps is not None else steps
    res = args.res or res
    spp = args.spp or spp
    from ..scene.parser import load_scene

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    scene = load_scene(os.path.join(root, "scenes", f"{name}.txt"))
    depth = args.depth or (3 if args.what == "mesh" else scene.trace_depth)
    scene = dataclasses.replace(scene, resolution=(res, res),
                                trace_depth=depth)
    t0 = time.time()

    def report(step, value, error):
        print(f"step {step:3d}: {np.round(value, 4)} error {error:.4f} "
              f"({time.time() - t0:.1f} s)", flush=True)

    if args.what == "light":
        errors = inverse_light(scene, steps, spp, device=args.device,
                               callback=report)
        start, end = errors[0], errors[-1]
    elif args.what == "albedo":
        start, end = inverse_albedo(scene, steps, spp, device=args.device,
                                    callback=report)
    else:
        start, end = inverse_mesh(scene, steps, spp, device=args.device,
                                  callback=report)
    print(f"{args.what}: {start:.6g} -> {end:.6g} in {steps} steps, "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0 if end < start else 1


if __name__ == "__main__":
    sys.exit(main())
