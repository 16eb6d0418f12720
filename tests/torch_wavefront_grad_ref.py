"""The wavefront's gradients through the reference and the port.

``case(name, nee)``: the scene file ``name`` at 16x16, depth 3, 2 samples
(iterations 1 and 2), the reference's ``render_loss_and_grad`` (its
wavefront under ``jax.value_and_grad``, jitted on the CPU) and the
port's ``render/diff.render_loss_and_grad(engine="wavefront",
device="cpu")``, each on the L2 loss against a target that is zero but
on the pixels where the two engines trace different paths.  Those are
the reference's tie flips (``tests/torch_wavefront_ref.py``: on cornell's
thin walls XLA's FMAs move a hit point into the wall), held to be pixels
where the reference's jitted image also parts from its numpy oracle;
there each engine's target is its own image, so those pixels add
nothing to either gradient, and the rest is compared leaf by leaf at the
tolerance at which the reference holds its planes engine's gradients
against its wavefront's (rtol 2e-3, atol 2e-5,
``tests/test_planes.py:278``), where the reference's entries are finite.
"""

import dataclasses
import functools

import jax
import numpy as np

import pathtrace_tpu as pt
from pathtrace_tpu.reference_oracle import oracle_iteration
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.render import diff as D

from torch_scenes import REPO

RES, DEPTH, SPP = (16, 16), 3, 2
RTOL, ATOL = 2e-3, 2e-5


def jax_scene(name, depth=DEPTH):
    return dataclasses.replace(pt.load_scene(f"{REPO}/scenes/{name}.txt"),
                               resolution=RES, trace_depth=depth)


def flips(js, img, nee=False):
    """(P,) bool: the pixels where the port's mean image ``img`` and the
    reference's part by more than 1e-3; raises unless each is also one
    where the reference's jitted image parts from its numpy oracle, and
    unless they are at most one pixel or 0.5% of them.  Returns (the
    flips, the reference's image)."""
    ref = np.asarray(jax.jit(lambda: JD.render_mean(js, 1, SPP,
                                                    nee=nee))())
    orc = sum(np.asarray(oracle_iteration(js, i, nee=nee)[0], np.float32)
              for i in range(1, SPP + 1)) / SPP
    flip = np.abs(img - ref).max(axis=-1) > 1e-3
    ref_flip = np.abs(orc - ref).max(axis=-1) > 1e-3
    assert not (flip & ~ref_flip).any(), np.nonzero(flip & ~ref_flip)
    assert flip.sum() <= max(1, 0.005 * flip.size), np.nonzero(flip)
    return flip, ref


@functools.lru_cache(maxsize=None)
def case(name, nee):
    """(loss, gradients) of the reference and the port, and the flips."""
    js = jax_scene(name)
    scene = convert.from_jax_scene(js)
    img = D.render_mean(scene, 1, SPP, nee=nee, device="cpu").numpy()
    flip, ref_img = flips(js, img, nee)
    t_ref = np.where(flip[:, None], ref_img, 0).astype(np.float32)
    t_port = np.where(flip[:, None], img, 0).astype(np.float32)
    ref = JD.render_loss_and_grad(js, t_ref, 1, SPP, nee=nee)
    got = D.render_loss_and_grad(scene, t_port, 1, SPP, nee=nee,
                                 device="cpu")
    return ref, got, flip


def hold_grads(got, want):
    """Each leaf of the port's gradients ``got`` against the reference's
    ``want`` (``split_params`` dicts) where the reference's are finite;
    returns the count of the other entries."""
    from test_torch_vjp import grad_groups

    got, want = grad_groups(got), grad_groups(want)
    assert set(got) == set(want)
    other = 0
    for name in sorted(want):
        fin = np.isfinite(want[name])
        other += int((~fin).sum())
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name][fin], want[name][fin],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    return other
