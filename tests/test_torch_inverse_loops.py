"""The inverse loops of the reference's ``examples/inverse_rendering.py``
and ``examples/inverse_mesh.py`` in the port (``render/inverse.py``).

``inverse_albedo`` runs beside the reference's own ``main`` at the stamp
size of the reference's ``tests/test_examples.py`` (32x32 d3 8 spp, 8
steps) and is held to it step by step: the albedo's gradient from K7 and
the albedo after each step.  ``inverse_mesh`` must reduce its loss at
that test's stamp (24x24 2 spp 5 steps, below its start, as the reference
test holds) and below 0.8x its start at the example's own size (48x48 4
spp, 2 steps; the bound of the example's ``main``); its steps are held to the
reference's loop in ``test_torch_inverse_mesh_ref.py``.  On the CPU they
run the plain versions of K1 and K7, and the planes engine.
"""

import dataclasses

import numpy as np
import pytest

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.render import inverse

from torch_scenes import REPO

# the albedo after a step, and its gradient, against the reference's:
# both loops run K1 and K7 on the same random streams, and their steps
# part only by float32 rounding (measured: 6e-8 on the albedo, 4e-7
# relative on the gradient)
ALBEDO_ATOL = 1e-6


def test_inverse_albedo_recovers_the_wall(monkeypatch):
    monkeypatch.chdir(REPO)  # the example reads scenes/cornell.txt
    monkeypatch.syspath_prepend(f"{REPO}/examples")
    import inverse_rendering

    ref_in, ref_g = [], []
    ref_grads = inverse_rendering.material_grads_pallas

    def ref_record(cur, *a, **k):
        ref_in.append(np.asarray(cur.materials.color)[2].copy())
        out = ref_grads(cur, *a, **k)
        ref_g.append(np.asarray(out[1]["color"])[2].copy())
        return out

    monkeypatch.setattr(inverse_rendering, "material_grads_pallas",
                        ref_record)
    ref_err0, ref_err = inverse_rendering.main(
        ["--steps", "8", "--res", "32", "--spp", "8", "--depth", "3"])

    port_g = []
    port_grads = inverse.material_grads

    def port_record(*a, **k):
        out = port_grads(*a, **k)
        port_g.append(out[1]["color"][2].numpy().copy())
        return out

    monkeypatch.setattr(inverse, "material_grads", port_record)
    scene = dataclasses.replace(ptt.load_scene(f"{REPO}/scenes/cornell.txt"),
                                resolution=(32, 32), trace_depth=3)
    seen = []
    err0, err = inverse.inverse_albedo(
        scene, steps=8, spp=8, device="cpu",
        callback=lambda step, albedo, e: seen.append((step, albedo, e)))
    assert err0 == pytest.approx(0.35, abs=1e-6)  # grey from (0.85, .35, .35)
    assert err0 == float(ref_err0)
    assert [s for s, _, _ in seen] == list(range(8)) and seen[-1][2] == err
    # the reference records the albedo going into each step: steps 1..7
    # start from the port's albedo after steps 0..6
    np.testing.assert_allclose(np.stack([a for _, a, _ in seen[:-1]]),
                               np.stack(ref_in[1:]), rtol=0, atol=ALBEDO_ATOL)
    np.testing.assert_allclose(np.stack(port_g), np.stack(ref_g), rtol=1e-4,
                               atol=ALBEDO_ATOL)
    assert err == pytest.approx(float(ref_err), abs=ALBEDO_ATOL)
    assert err < 0.7 * err0


def _bumpmesh(res):
    return dataclasses.replace(
        ptt.load_scene(f"{REPO}/scenes/cornell_bumpmesh.txt"),
        resolution=(res, res), trace_depth=3)


def test_inverse_mesh_loss_decreases():
    seen = []
    loss0, loss1 = inverse.inverse_mesh(
        _bumpmesh(24), steps=5, spp=2, device="cpu",
        callback=lambda step, loss, rms: seen.append((loss, rms)))
    assert 0 < loss1 < loss0
    assert seen[0][0] == pytest.approx(loss0, rel=1e-6)
    assert all(np.isfinite(v) for pair in seen for v in pair)


def test_inverse_mesh_meets_the_examples_bound_at_its_size():
    # the reference example's default size (48x48 d3 4 spp) and its bound,
    # after two of its 40 steps (the loss falls to about 0.25x in the
    # first)
    loss0, loss1 = inverse.inverse_mesh(_bumpmesh(48), steps=2, spp=4,
                                        device="cpu")
    assert loss1 < 0.8 * loss0


def test_inverse_mesh_folds_every_triangle(monkeypatch):
    # the loop moves vertices out of the boxes of the BVH built for the
    # loaded mesh, so it renders without that BVH
    calls = []
    real = inverse.diff.render_loss_and_grad

    def record(*a, **k):
        calls.append(k.get("use_bvh", True))
        return real(*a, **k)

    monkeypatch.setattr(inverse.diff, "render_loss_and_grad", record)
    inverse.inverse_mesh(_bumpmesh(8), steps=1, spp=1, device="cpu")
    assert calls == [False, False]


def test_inverse_main_runs_a_loop(capsys):
    rc = inverse.main(["albedo", "--device", "cpu", "--steps", "2", "--res",
                       "16", "--spp", "2", "--depth", "2"])
    assert rc in (0, 1)  # 1: the error did not fall in two steps
    assert "albedo: 0.35 ->" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        inverse.main(["shape"])
