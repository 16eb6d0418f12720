"""Inverse rendering: recover a light's position from a target render.

The loop of the reference's ``examples/inverse_light.py``: render the
target, move the light by ``offset``, then per step render the current
scene with NEE (K1), take the cotangent of the image's mean squared
error, and step the light's translation along the gradient that the
reverse sweep (K8, ``ops/cuda/vjp.render_vjp``) gives, the step capped
at ``max_step`` world units.  Geometry gradients need NEE: at fixed
random draws, pure BSDF sampling is piecewise constant in the
transforms, and NEE's cos cos' / r^2 term carries the continuous
dependence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cuda import megakernel as K
from ..ops.cuda import vjp


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
