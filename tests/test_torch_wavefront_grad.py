"""The wavefront's gradients: ``render/diff.render_loss_and_grad(
engine="wavefront")`` against the reference's on cornell with NEE and
on cornell_glass (``tests/torch_wavefront_grad_ref.py`` gives the rig
and the bounds); ``remat`` recomputes each bounce and changes no bit of
the gradients (the reference's ``tests/test_diff.py:158``); and the
finite-difference checks of the reference's ``tests/test_diff.py`` and
``tests/test_nee.py`` on the port."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.render import diff as D

import torch_wavefront_grad_ref as G
from torch_scenes import load


@pytest.mark.parametrize("name,nee", [("cornell", True),
                                      ("cornell_glass", False)],
                         ids=["cornell-nee", "cornell_glass"])
def test_wavefront_gradients_match_reference(name, nee):
    (l_ref, g_ref), (loss, g), _ = G.case(name, nee)
    assert loss.shape == () and loss.device.type == "cpu"
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-5)
    assert G.hold_grads(g, g_ref) == 0
    assert float(g["materials"].color.abs().max()) > 0
    if nee:  # NEE makes the transforms' gradients continuous
        assert float(g["translation"].abs().max()) > 0


def _tiny(depth=3):
    return load("cornell", res=G.RES, depth=depth)


def _loss(scene, nee=False):
    img = D.render_mean(scene, 1, 2, nee=nee, device="cpu")
    return float((img ** 2).mean())


@pytest.fixture(scope="module")
def tiny_grads():
    scene = _tiny()
    _, g = D.render_loss_and_grad(scene, np.zeros((256, 3), np.float32), 1,
                                  2, device="cpu")
    return scene, g


def _fd(scene, group, field, idx, eps, nee=False):
    def at(delta):
        if group == "materials":
            arr = np.array(getattr(scene.materials, field), np.float32)
            arr[idx] += delta
            s = dataclasses.replace(scene, materials=dataclasses.replace(
                scene.materials, **{field: arr}))
        else:
            arr = np.array(getattr(scene.geoms, field), np.float32)
            arr[idx] += delta
            s = dataclasses.replace(scene, geoms=dataclasses.replace(
                scene.geoms, **{field: arr}))
        return _loss(s, nee)

    return (at(eps) - at(-eps)) / (2 * eps)


@pytest.mark.parametrize("mat,ch", [(m, c) for m in (1, 2) for c in range(3)])
def test_albedo_gradient_matches_central_difference(tiny_grads, mat, ch):
    scene, g = tiny_grads
    fd = _fd(scene, "materials", "color", (mat, ch), 1e-3)
    an = float(g["materials"].color[mat, ch])
    assert an == pytest.approx(fd, rel=0.02, abs=1e-6)


def test_emittance_gradient_matches_central_difference(tiny_grads):
    scene, g = tiny_grads
    fd = _fd(scene, "materials", "emittance", (0,), 1e-3)
    an = float(g["materials"].emittance[0])
    assert an != 0
    assert an == pytest.approx(fd, rel=0.02)


def test_spec_color_gradient_matches_central_difference(tiny_grads):
    scene, g = tiny_grads
    fd = _fd(scene, "materials", "spec_color", (4, 0), 1e-3)
    an = float(g["materials"].spec_color[4, 0])
    assert an == pytest.approx(fd, rel=0.05, abs=1e-7)


def test_unused_and_geometry_gradients_are_zero_without_nee(tiny_grads):
    # nothing refracts in cornell.txt; BSDF-sampled radiance is piecewise
    # constant in the transforms at fixed draws
    scene, g = tiny_grads
    assert float(g["materials"].ior.abs().max()) == 0
    assert torch.isfinite(g["translation"]).all()
    assert float(g["translation"].abs().max()) == pytest.approx(0, abs=1e-6)
    assert _fd(scene, "geoms", "translation", (0, 1), 1e-4) == \
        pytest.approx(0.0, abs=1e-4)


def test_light_translation_gradient_with_nee_matches_central_difference():
    scene = _tiny(depth=2)
    _, g = D.render_loss_and_grad(scene, np.zeros((256, 3), np.float32), 1,
                                  2, nee=True, device="cpu")
    an = float(g["translation"][0, 1])  # the light's height
    assert np.isfinite(an) and an != 0
    fd = _fd(scene, "geoms", "translation", (0, 1), 1e-3, nee=True)
    assert an == pytest.approx(fd, rel=0.05)
    assert float(g["scale"].abs().sum()) > 0


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_remat_gives_the_same_gradients(nee):
    scene = _tiny()
    out = []
    for remat in (True, False):
        params = D.requires_grad(D.split_params(scene))
        img = D.render_mean(D.merge_params(scene, params), 1, 2,
                            remat=remat, nee=nee, device="cpu")
        loss = (img ** 2).mean()
        loss.backward()
        out.append((loss.detach(), D.grads(params)))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for x, y in zip(D.leaves(ga), D.leaves(gb)):
        assert torch.equal(x, y)


def test_sort_gives_the_mask_gradients():
    scene = _tiny()
    tgt = np.zeros((256, 3), np.float32)
    a = D.render_loss_and_grad(scene, tgt, 1, 2, device="cpu")
    b = D.render_loss_and_grad(scene, tgt, 1, 2, compaction="sort",
                               device="cpu")
    assert torch.equal(a[0], b[0])
    for x, y in zip(D.leaves(a[1]), D.leaves(b[1])):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)
