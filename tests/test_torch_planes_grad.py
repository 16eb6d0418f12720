"""The planes engine's gradients: ``render/diff.render_loss_and_grad(...,
engine="planes")`` against the reference's.

On the scene of the reference's ``tests/test_planes.py::TestBvhGrad``
(cornell_mesh at 24x24 depth 3, NEE, 2 samples, a black target), the
port's loss and every parameter group, ``tri_verts`` included, against
the reference's ``render_loss_and_grad(engine="planes")`` (``jax.grad``
of its planes engine with ``bvh_grad``), to rtol 2e-3 / atol 2e-5, the
tolerance at which the reference holds its planes engine's gradients
against its wavefront's (``tests/test_planes.py:278``); the BVH's
gradients against the
linear fold's (``use_bvh=False``, their oracle) to rtol 1e-3 / atol
1e-7, the reference's own check; and the largest ``tri_verts`` entry
against a central difference of the port's loss (rel 0.05), as
``test_tri_verts_grad_matches_fd`` holds the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.render import diff as D

from test_torch_vjp import grad_groups
from torch_scenes import REPO, load

N_ITERS = 2


@pytest.fixture(scope="module")
def bvh_case():
    """(the port's scene, the target, the reference's (loss, gradients),
    the port's)."""
    js = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/cornell_mesh.txt"),
                             resolution=(24, 24), trace_depth=3)
    scene = convert.from_jax_scene(js)
    tgt = np.zeros((js.pixel_count, 3), np.float32)
    ref = JD.render_loss_and_grad(js, tgt, 1, N_ITERS, nee=True,
                                  engine="planes")
    got = D.render_loss_and_grad(scene, tgt, 1, N_ITERS, nee=True,
                                 engine="planes", device="cpu")
    return scene, tgt, ref, got


def test_planes_gradients_match_reference(bvh_case):
    _, _, (l_ref, g_ref), (loss, g) = bvh_case
    assert loss.shape == () and loss.device.type == "cpu"
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-6)
    got, want = grad_groups(g), grad_groups(g_ref)
    assert set(got) == set(want) and "tri_verts" in got
    assert np.abs(got["tri_verts"]).max() > 0
    for name in sorted(want):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=2e-3,
                                   atol=2e-5, err_msg=name)


def test_bvh_gradients_match_the_linear_fold(bvh_case):
    scene, tgt, _, (loss, g) = bvh_case
    loss_lin, g_lin = D.render_loss_and_grad(
        scene, tgt, 1, N_ITERS, nee=True, engine="planes", use_bvh=False,
        device="cpu")
    np.testing.assert_allclose(float(loss_lin), float(loss), rtol=1e-6)
    got, want = grad_groups(g), grad_groups(g_lin)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=1e-7, err_msg=name)


def test_tri_verts_gradient_matches_central_difference(bvh_case):
    scene, tgt, _, (_, g) = bvh_case
    g_tv = g["tri_verts"].numpy()
    idx = np.unravel_index(np.argmax(np.abs(g_tv)), g_tv.shape)
    eps = 2e-3
    tv0 = np.asarray(scene.mesh.tri_verts, np.float32)

    def loss_at(delta):
        tv = tv0.copy()
        tv[idx] += delta
        s = dataclasses.replace(scene, mesh=dataclasses.replace(
            scene.mesh, tri_verts=tv))
        return float(D.render_mean(s, 1, N_ITERS, nee=True, engine="planes",
                                   device="cpu").sub(
            torch.as_tensor(tgt)).pow(2).mean())

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert g_tv[idx] == pytest.approx(fd, rel=0.05, abs=1e-8)


@pytest.mark.parametrize("engine,err,match", [
    ("xla", ValueError, "engine")])
def test_other_engines_raise(engine, err, match):
    scene = load("cornell", res=(8, 8), depth=2)
    with pytest.raises(err, match=match):
        D.render_loss_and_grad(scene, np.zeros((64, 3), np.float32), 1, 1,
                               engine=engine, device="cpu")


def test_planes_and_wavefront_engines_give_one_image():
    # the same draws and the same estimator: the two engines trace the
    # same paths (within the tie bound), as the reference's do
    scene = load("cornell_mesh", res=(12, 10), depth=3)
    a = D.render_mean(scene, 1, 2, nee=True, engine="planes", device="cpu")
    b = D.render_mean(scene, 1, 2, nee=True, engine="wavefront",
                      device="cpu")
    d = (a - b).abs().amax(dim=-1)
    assert float((d > 1e-3).float().mean()) < 0.005


def test_planes_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = load("cornell", res=(8, 8), depth=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        D.render_loss_and_grad(scene, np.zeros((64, 3), np.float32), 1, 1,
                               engine="planes")


def test_planes_ignores_compaction_and_remat():
    # the wavefront's options choose how it runs, not what it computes:
    # the planes engine gives one image for each, as the reference's does
    scene = load("cornell_mesh", res=(8, 6), depth=2)
    want = D.render_mean(scene, 1, 1, engine="planes", device="cpu")
    got = D.render_mean(scene, 1, 1, compaction="sort", remat=False,
                        engine="planes", device="cpu")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="compaction"):
        D.render_loss_and_grad(scene, np.zeros((48, 3), np.float32), 1, 1,
                               compaction="bogus", engine="planes",
                               device="cpu")
