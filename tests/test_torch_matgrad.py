"""K7, the analytic material gradients: the port's plain version against
the reference's ``material_grads_pallas(..., interpret=True)``.

The cases and tolerances are those of ``tests/test_grad_kernel.py``:
cornell 16x16 d3; cornell 12x12 d3 at 3 spp; cornell_glass 16x16 d4
with its aperture at 0; the white walls at has_reflective 0.4 (12x12
d3).  The pixels where the two forwards differ by 1e-4 or more (tie
flips) are masked out of the random cotangent on both sides, as the
reference's tests mask them.  The rejections are the reference's, and
NEE and Russian roulette, which the reference's entry point cannot ask
for.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import material_grads_pallas
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import matgrad as MG

from torch_scenes import REPO


def _cornell(res, depth, refl=None, name="cornell", aperture=None):
    scene = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/{name}.txt"),
                                resolution=res, trace_depth=depth)
    if refl is not None:
        m = scene.materials
        r = np.asarray(m.has_reflective).copy()
        r[1] = refl
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(m, has_reflective=r))
    if aperture is not None:
        scene = dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, aperture=np.float32(aperture)))
    return scene


# name -> (reference scene, spp, (rtol, atol) by gradient)
CASES = {
    "cornell": (lambda: _cornell((16, 16), 3), 1,
                dict(color=(1e-5, 1e-4), spec_color=(1e-5, 1e-4),
                     emittance=(1e-5, 1e-4))),
    "multi_spp": (lambda: _cornell((12, 12), 3), 3,
                  dict(color=(1e-5, 1e-4))),
    "glass": (lambda: _cornell((16, 16), 4, name="cornell_glass",
                               aperture=0.0), 1,
              dict(color=(1e-4, 1e-3), spec_color=(1e-4, 1e-3))),
    "refl_0.4": (lambda: _cornell((12, 12), 3, refl=0.4), 1,
                 dict(has_reflective=(1e-4, 1e-3))),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, port scene, ct, spp, the reference's (rad, grads))."""
    make, spp, _ = CASES[request.param]
    js = make()
    n_pix = js.pixel_count
    ones = np.ones((n_pix, 3), np.float32)
    rk, _ = material_grads_pallas(js, ones, 1, spp, interpret=True)
    scene = convert.from_jax_scene(js)
    rp, _ = MG.material_grads(scene, ones, 1, spp, device="cpu")
    agree = np.abs(np.asarray(rk) - rp.numpy()).max(-1) < 1e-4
    assert agree.mean() > 0.98
    ct = np.where(agree[:, None], np.random.RandomState(0).rand(n_pix, 3),
                  0).astype(np.float32)
    ref = material_grads_pallas(js, ct, 1, spp, interpret=True)
    return request.param, scene, ct, spp, ref


def test_plain_k7_matches_reference(case):
    name, scene, ct, spp, (rk, gk) = case
    rad, g = MG.material_grads(scene, ct, 1, spp, device="cpu")
    assert rad.device.type == "cpu" and rad.shape == (scene.pixel_count, 3)
    assert set(g) == {"color", "spec_color", "emittance", "has_reflective"}
    for key, val in g.items():
        assert val.shape == np.asarray(gk[key]).shape, key
        assert bool(torch.isfinite(val).all()), key
    for key, (rtol, atol) in CASES[name][2].items():
        np.testing.assert_allclose(g[key].numpy(), np.asarray(gk[key]),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_plain_k7_radiance_is_the_plain_trace(case):
    # K7's radiance is K1's: the plain trace of the same tables
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    _, scene, ct, spp, _ = case
    rad, _ = MG.material_grads(scene, ct, 1, spp, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu"), it0=1, n_spp=spp)
    assert torch.equal(rad, want)


def _scene(name, **edits):
    scene = ptt.load_scene(f"{REPO}/scenes/{name}.txt")
    return dataclasses.replace(scene, resolution=(8, 8), **edits)


@pytest.mark.parametrize("what,scene,kw,match", [
    ("checker", lambda: _scene("cornell_checker"), {}, "CHECKER"),
    ("sss", lambda: _sss(), {}, "SSS"),
    ("texture", lambda: _scene("cornell_tex"), {}, "image-textured"),
    ("nee", lambda: _scene("cornell"), dict(nee=True), "NEE"),
    ("rr", lambda: _scene("cornell"), dict(rr=True), "Russian roulette"),
    ("depth", lambda: _scene("cornell", trace_depth=64), {}, "depth"),
    ("materials", lambda: _many_materials(), {}, "128 materials"),
])
def test_rejects_what_the_reference_rejects(what, scene, kw, match):
    sc = scene()
    with pytest.raises(NotImplementedError, match=match):
        MG.material_grads(sc, np.ones((sc.pixel_count, 3), np.float32), 1,
                          1, device="cpu", **kw)


def _sss():
    from torch_scenes import SSS, load

    return dataclasses.replace(load("cornell_glass", (SSS,)),
                               resolution=(8, 8))


def _many_materials():
    scene = _scene("cornell")
    m = scene.materials
    idx = np.zeros(129, np.int64)
    return dataclasses.replace(scene, materials=dataclasses.replace(m, **{
        f.name: np.asarray(getattr(m, f.name))[idx]
        for f in dataclasses.fields(m) if getattr(m, f.name) is not None}))


def test_material_grads_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene("cornell")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        MG.material_grads(scene, np.ones((64, 3), np.float32), 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.material_grads(scene, np.ones((64, 3), np.float32), 1, 1)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    scene = _scene("cornell", trace_depth=3)
    job = ptt.prepare(scene, "cpu")
    mtab = MG.material_table(scene, "cpu")
    mat_of = tuple(int(m) for m in scene.geoms.material_id)
    ct = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    got = MG.trace_k7(job, mtab, mat_of, ct, 1, 2)
    want = MG.k7_plain(job, mtab, mat_of, ct, 1, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sum(MG.LAUNCHES.values()) == 0
