"""Texel gradients: a map of ``scene.textures`` swapped for a float32
tensor that requires grad, differentiated through the port's wavefront
(``pathtrace_iteration``) and planes engine (``render/diff.planes_iteration``,
the megakernel's plain version over the float texel table), as the
reference's ``tests/test_planes.py::test_texel_gradients_planes`` does with
``jax.grad``.

cornell_tex at 24x24 depth 3, 1 sample, NEE (without NEE no path through
the textured geoms reaches the light at this depth), the loss the mean of
the image, the map of material 5.  The port's two engines agree at the
reference's rtol 1e-3 / atol 1e-7.  Against the reference's float32
``jax.grad``: rtol 1e-3 / atol 2.5e-7.  The reference's own float32
readings part from its float64 one by up to 1.23e-7, one entry outside
1e-3 / 1e-7 (XLA's contracted multiply-adds move a tap); the port's
float32 reading is within 2.7e-8 of that float64 reading, no entry
outside (``JAX_PLATFORMS=cpu python tests/torch_reading64.py texel``).
So the tolerance is the reference's plus 1.5e-7 for its own rounding.
The reference's planes engine is held in
``tests/test_torch_texel_grad_planes.py`` (its compile takes a minute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.render import diff as D
from pathtrace_tpu_torch.render import integrator as I

from torch_scenes import REPO

RES, DEPTH, MATERIAL = (24, 24), 3, 5
RTOL, ATOL = 1e-3, 1e-7
ATOL_REFERENCE = 2.5e-7


def texel_scenes():
    """(the reference's cornell_tex at the rig's size, the port's, the id
    of material ``MATERIAL``'s map)."""
    js = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/cornell_tex.txt"),
                             resolution=RES, trace_depth=DEPTH)
    tid = js.texture_ids[MATERIAL]
    assert tid >= 0
    return js, convert.from_jax_scene(js), tid


def swap(scene, tid, tex):
    return dataclasses.replace(scene, textures=tuple(
        tex if i == tid else t for i, t in enumerate(scene.textures)))


def port_texel_grad(scene, tid, iteration):
    """d mean(rad) / d the map ``tid`` through ``iteration(scene, 1,
    nee=True, device="cpu")``."""
    tex = torch.tensor(np.asarray(scene.textures[tid]), requires_grad=True)
    rad, _ = iteration(swap(scene, tid, tex), 1, nee=True, device="cpu")
    rad.mean().backward()
    return tex.grad.numpy()


def reference_texel_grad(js, tid, iteration):
    """The reference's test's ``jax.grad`` of mean(rad) through
    ``iteration(scene, 1, nee=True)``."""
    return np.asarray(jax.grad(lambda t: jnp.mean(
        iteration(swap(js, tid, t), 1, nee=True)[0]))(
            jnp.asarray(js.textures[tid])))


@pytest.fixture(scope="module")
def rig():
    js, scene, tid = texel_scenes()
    return js, scene, tid, {
        "planes": port_texel_grad(scene, tid, D.planes_iteration),
        "wavefront": port_texel_grad(scene, tid, I.pathtrace_iteration)}


@pytest.mark.parametrize("engine", ["planes", "wavefront"])
def test_texel_gradients_are_not_zero(rig, engine):
    g = rig[3][engine]
    assert g.shape == rig[1].textures[rig[2]].shape
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_texel_gradients_planes_match_wavefront(rig):
    got = rig[3]
    np.testing.assert_allclose(got["planes"], got["wavefront"], rtol=RTOL,
                               atol=ATOL)


def test_texel_gradients_wavefront_match_reference(rig):
    js, _, tid, got = rig
    want = reference_texel_grad(js, tid, pt.pathtrace_iteration)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got["wavefront"], want, rtol=RTOL,
                               atol=ATOL_REFERENCE)


def test_texel_gradients_reach_a_map_on_the_card_side_of_resident():
    # resident() moves a map that requires grad with its graph, and the
    # wavefront's bump map path keeps it too (cornell_bumpmesh's BUMPTEX)
    js = dataclasses.replace(
        pt.load_scene(f"{REPO}/scenes/cornell_bumpmesh.txt"),
        resolution=(12, 12), trace_depth=2)
    scene = convert.from_jax_scene(js)
    tid = next(t for t in scene.bump_texture_ids if t >= 0)
    for iteration in (I.pathtrace_iteration, D.planes_iteration):
        g = port_texel_grad(scene, tid, iteration)
        assert np.isfinite(g).all() and np.abs(g).sum() > 0, iteration
