"""The interactive camera (``render/interact.py``), the cases of the
reference's ``tests/test_interactive.py`` run on the reference's functions
and on the port's (``impl``), the two held equal, and the restart rule on
the port's renderers: after a camera key the accumulation restarts, and
the restarted render equals a fresh render with the moved camera, bit for
bit (every draw is a function of the iteration, the pixel and the bounce).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu.render import interact as ref_interact
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import integrator as I
from pathtrace_tpu_torch.render import interact as port_interact

from torch_scenes import REPO

CORNELL = f"{REPO}/scenes/cornell.txt"


@pytest.fixture(params=["reference", "port"])
def impl(request, cornell_scene):
    """(the module under test, a camera of its own package's scene)."""
    if request.param == "reference":
        return ref_interact, cornell_scene.camera
    return port_interact, ptt.load_scene(CORNELL).camera


def test_key_motion_table_is_the_references():
    assert port_interact.KEY_MOTION == ref_interact.KEY_MOTION


@pytest.mark.parametrize("key", sorted(ref_interact.KEY_MOTION))
def test_camera_motion_equals_the_references(cornell_scene, key):
    want = ref_interact.apply_camera_motion(
        cornell_scene.camera, *ref_interact.KEY_MOTION[key])
    got = port_interact.apply_camera_motion(
        ptt.load_scene(CORNELL).camera, *port_interact.KEY_MOTION[key])
    for f in ("position", "view", "up"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_orbit_preserves_orthonormal_basis(impl):
    mod, cam = impl
    c = mod.apply_camera_motion(cam, 0.1, -0.1, (0.0, 0.0, 0.0))
    v = np.asarray(c.view, np.float64)
    u = np.asarray(c.up, np.float64)
    assert abs(np.linalg.norm(v) - 1.0) < 1e-6
    assert abs(np.linalg.norm(u) - 1.0) < 1e-6
    assert abs(float(v @ u)) < 1e-6


def test_phi_rotates_about_up(impl):
    mod, cam = impl
    c = mod.apply_camera_motion(cam, 0.0, 0.3, (0.0, 0.0, 0.0))
    np.testing.assert_allclose(c.up, cam.up, atol=1e-6)
    cosang = float(np.asarray(c.view, np.float64)
                   @ np.asarray(cam.view, np.float64))
    assert abs(cosang - np.cos(0.3)) < 1e-6


def test_theta_rotates_about_right(impl):
    mod, cam = impl
    v0 = np.asarray(cam.view, np.float64)
    u0 = np.asarray(cam.up, np.float64)
    c = mod.apply_camera_motion(cam, 0.25, 0.0, (0.0, 0.0, 0.0))
    np.testing.assert_allclose(
        np.cross(np.asarray(c.view, np.float64),
                 np.asarray(c.up, np.float64)),
        np.cross(v0, u0), atol=1e-6)
    assert abs(float(np.asarray(c.view, np.float64) @ v0)
               - np.cos(0.25)) < 1e-6


def test_translation_basis(impl):
    mod, cam = impl
    v = np.asarray(cam.view, np.float64)
    u = np.asarray(cam.up, np.float64)
    r = np.cross(v, u)
    for key, axis, sign in [("w", v, +1), ("s", v, -1), ("d", r, +1),
                            ("a", r, -1), ("r", u, +1), ("f", u, -1)]:
        c = mod.apply_camera_motion(cam, *mod.KEY_MOTION[key])
        np.testing.assert_allclose(
            np.asarray(c.position, np.float64),
            np.asarray(cam.position, np.float64) + sign * 0.1 * axis,
            atol=1e-6, err_msg=key)
        np.testing.assert_allclose(c.view, cam.view, atol=1e-7)


def test_arrow_key_signs(impl):
    mod, _ = impl
    assert mod.KEY_MOTION["up"][0] == pytest.approx(0.1)
    assert mod.KEY_MOTION["down"][0] == pytest.approx(-0.1)
    assert mod.KEY_MOTION["left"][1] == pytest.approx(0.1)
    assert mod.KEY_MOTION["right"][1] == pytest.approx(-0.1)


def test_stale_events_ignored(impl, tmp_path):
    mod, cam = impl
    ctrl = str(tmp_path / "c.ctrl")
    mod.send_key(ctrl, "left")  # before the session starts
    _, changed, save, quit_ = mod.InteractiveSession(ctrl).poll(cam)
    assert not (changed or save or quit_)


def test_event_kinds(impl, tmp_path):
    mod, cam = impl
    ctrl = str(tmp_path / "c.ctrl")
    sess = mod.InteractiveSession(ctrl)
    for key in ("space", "left", "esc"):
        mod.send_key(ctrl, key)
    cam2, changed, save, quit_ = sess.poll(cam)
    assert changed and save and quit_
    assert not np.allclose(cam2.view, cam.view)
    _, changed, save, quit_ = sess.poll(cam)  # drained
    assert not (changed or save or quit_)


def test_partial_line_not_consumed(impl, tmp_path):
    mod, cam = impl
    ctrl = str(tmp_path / "c.ctrl")
    sess = mod.InteractiveSession(ctrl)
    with open(ctrl, "a") as f:
        f.write("lef")  # the writer in the middle of a line
    assert not sess.poll(cam)[1]
    with open(ctrl, "a") as f:
        f.write("t\n")
    assert sess.poll(cam)[1]


@pytest.mark.parametrize("engine", ["wavefront", "k1"])
def test_restart_equals_fresh_render(tmp_path, engine):
    """A render, a camera key, the accumulation restarted: equal to a
    fresh render of the moved scene, bit for bit."""
    def iteration(scene, it):
        if engine == "wavefront":
            return I.pathtrace_iteration(scene, it, device="cpu")[0]
        return K.trace_k1(K.prepare(scene, "cpu"), it, 1)[0]

    scene = dataclasses.replace(ptt.load_scene(CORNELL), resolution=(16, 16),
                                trace_depth=2)
    ctrl = str(tmp_path / "c.ctrl")
    sess = port_interact.InteractiveSession(ctrl)
    accum = sum(iteration(scene, it) for it in (1, 2))  # to be discarded
    port_interact.send_key(ctrl, "left")
    cam2, changed, _, _ = sess.poll(scene.camera)
    assert changed
    moved = dataclasses.replace(scene, camera=cam2)
    accum = torch.zeros_like(accum)  # the restart
    for it in (1, 2, 3):
        accum = accum + iteration(moved, it)
    fresh = dataclasses.replace(
        scene, camera=port_interact.apply_camera_motion(
            scene.camera, *port_interact.KEY_MOTION["left"]))
    want = torch.zeros_like(accum)
    for it in (1, 2, 3):
        want = want + iteration(fresh, it)
    assert torch.equal(accum, want)
    assert not torch.equal(iteration(scene, 1), iteration(moved, 1))
