"""The wavefront's gradients without NEE on cornell, and
``render_value_and_pixel_grad``: ``render/diff.render_loss_and_grad(
engine="wavefront")`` and ``render_value_and_pixel_grad`` against the
reference's on cornell 16x16 depth 3, 2 samples
(``tests/torch_wavefront_grad_ref.py`` gives the rig and the bounds)."""

import jax
import numpy as np
import pytest

import pathtrace_tpu_torch as ptt
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.render import diff as D

import torch_wavefront_grad_ref as G


def test_wavefront_gradients_match_reference_without_nee():
    (l_ref, g_ref), (loss, g), _ = G.case("cornell", False)
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-5)
    assert G.hold_grads(g, g_ref) == 0
    assert float(g["materials"].has_reflective.abs().max()) > 0


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["sum", "weighted"])
def test_value_and_pixel_grad_match_reference(weighted):
    js = G.jax_scene("cornell")
    scene = convert.from_jax_scene(js)
    img = D.render_mean(scene, 1, G.SPP, device="cpu").numpy()
    flip, _ = G.flips(js, img)
    # weights that leave out the reference's flipped pixels
    rs = np.random.default_rng(31)
    w = (rs.uniform(0.5, 1.5, img.shape) if weighted
         else np.ones(img.shape)).astype(np.float32)
    w[flip] = 0
    ref_v, ref_g = jax.jit(lambda: JD.render_value_and_pixel_grad(
        js, 1, G.SPP, pixel_weights=w))()
    v, g = ptt.render_value_and_pixel_grad(scene, 1, G.SPP, pixel_weights=w,
                                           device="cpu")
    np.testing.assert_allclose(float(v), float(ref_v), rtol=1e-5)
    assert G.hold_grads(g, ref_g) == 0
