"""K8, the reverse sweep: the port's plain version against the reference.

The port's ``render_vjp(..., device="cpu")`` (autograd over the plain
trace, chained through the packing to ``split_params``) against
``jax.grad`` of the reference's planes engine
(``render/plane_engine._batch_jit_planes``: the megakernel's own trace
under XLA, which ``diff.render_loss_and_grad(engine="planes")``
differentiates), on the 4-geom rig of ``tests/test_vjp_kernel.py`` at
16x16 depth 2, with NEE and without: every parameter group to rtol 2e-4
/ atol 3e-4, the reference's own tolerance.  The pixels where the two
forwards differ by 1e-4 or more (tie flips) are masked out of the random
cotangent on both sides, as the reference's tests mask them.  Every
gradient is finite.  ``tests/test_torch_vjp_interpret.py`` holds one
case against the reference's kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import _scene_features
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu.render.plane_engine import _batch_jit_planes
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.render import diff as D
from pathtrace_tpu_torch.scene.bvh import without_bvh

from torch_scenes import REPO, load

RTOL, ATOL = 2e-4, 3e-4


def rig_text():
    """The 4-geom rig of the reference's ``tests/test_vjp_kernel.py``."""
    with open(f"{REPO}/tests/test_vjp_kernel.py") as f:
        return f.read().split('RIG = """\\\n')[1].split('"""')[0]


def rig(res=(16, 16), depth=2):
    js = dataclasses.replace(pt.parse_scene(rig_text()), resolution=res,
                             trace_depth=depth)
    return js, convert.from_jax_scene(js)


def masked_ct(rad_ref, rad, seed=0):
    """A random cotangent, zero where the two forwards differ."""
    agree = np.abs(np.asarray(rad_ref) - np.asarray(rad)).max(-1) < 1e-4
    assert agree.mean() > 0.95
    return np.where(agree[:, None],
                    np.random.RandomState(seed).rand(agree.shape[0], 3),
                    0).astype(np.float32)


def grad_groups(g):
    """{name: numpy gradient} of each leaf that is on of a
    ``split_params`` dict of gradients (the port's or the reference's)."""
    return {name: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for name, v in D.named_leaves(g)}


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def rig_case(request):
    """(nee, port scene, ct, the reference's gradients) on the rig."""
    nee = request.param
    js, scene = rig()
    feat = _scene_features(js)

    def fwd(params):
        rad, _ = _batch_jit_planes(JD.merge_params(js, params), 1, 1, feat,
                                   nee, False, (), (), (), bvh_grad=True)
        return rad

    params = JD.split_params(js)
    rad_ref = jax.jit(fwd)(params)
    rad, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                           n_spp=1)
    ct = masked_ct(rad_ref, rad.numpy())
    gref = jax.jit(jax.grad(
        lambda p: jnp.sum(jnp.asarray(ct) * fwd(p))))(params)
    return nee, scene, ct, gref


def test_plain_k8_matches_reference(rig_case):
    nee, scene, ct, gref = rig_case
    _, g = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    got = grad_groups(g)
    want = grad_groups(gref)
    assert set(got) == set(want)
    if nee:
        # the NEE term carries the geometry: its gradients are not zero
        assert np.abs(want["translation"]).max() > 0.1
    for name in sorted(want):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_render_vjp_returns_the_plain_radiance(rig_case):
    # the radiance of render_vjp is the plain trace's, on the same tables
    nee, scene, ct, _ = rig_case
    rad, g = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
    assert tuple(g) == D.KEYS


@pytest.mark.parametrize("nee", [False, True])
def test_cornell_gradients_are_finite(nee):
    scene = load("cornell", res=(12, 12), depth=4)
    ct = np.random.RandomState(1).rand(144, 3).astype(np.float32)
    rad, g = ptt.render_vjp(scene, ct, 1, 2, nee=nee, device="cpu")
    assert bool(torch.isfinite(rad).all())
    leaves = D.leaves(g)
    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves)
    assert float(g["materials"].color.abs().max()) > 0


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    # cornell (no section) and cornell_glass (glass, imperfect specular,
    # depth of field: K8's mask 135)
    for name in ("cornell", "cornell_glass"):
        job = K.prepare(load(name, res=(8, 8), depth=3), "cpu", nee=True)
        ct = torch.rand((64, 3), generator=torch.Generator().manual_seed(2))
        args = (job["cam"], job["mats"], job["gmat"], job["geom_types"], 8,
                8, 3, 1, 2, job["lights"], ct, None, None, (),
                job["features"])
        before = sum(VJ.LAUNCHES.values())
        got = VJ.trace_k8(*args)
        want = VJ.k8_plain(*args)
        assert torch.equal(got[0], want[0])
        assert len(got[1]) == 4
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        assert sum(VJ.LAUNCHES.values()) == before
        if any(job["features"]):
            # the sections take part: the trace without them is another
            plain = VJ.k8_plain(*args[:11])
            assert not torch.equal(plain[0], want[0])


def test_render_vjp_traces_the_scene_sections():
    # the sections reach the plain version's trace (K8's plain version
    # once traced every scene without them)
    scene = load("cornell_glass", res=(10, 10), depth=3)
    ct = np.random.RandomState(3).rand(100, 3).astype(np.float32)
    rad, g = ptt.render_vjp(scene, ct, 1, 1, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu"), it0=1, n_spp=1)
    assert torch.equal(rad, want)
    assert tuple(g) == D.KEYS


# the ids are the cases' names from before meshes rendered; the sections
# (glass, checker, ...) render since K8's section builds
@pytest.mark.parametrize("name,edits,item", [
    pytest.param("cornell_mesh", (), "without a BVH",
                 id="cornell_mesh-edits2-item 3a"),
    pytest.param("cornell_tex", (), "item 3a'",
                 id="cornell_tex-edits3-item 3a"),
])
def test_render_vjp_rejects_what_k8_does_not_trace(name, edits, item):
    # a mesh with its BVH renders (tests/test_torch_meshgrad.py); stripped
    # of it, it raises, as the reference's render_vjp_pallas does
    scene = load(name, edits, res=(8, 8), depth=2)
    if scene.mesh.count:
        scene = without_bvh(scene)
    match = f"ROADMAP .*{item}" if item.startswith("item") else item
    with pytest.raises(NotImplementedError, match=match):
        ptt.render_vjp(scene, np.ones((64, 3), np.float32), 1, 1,
                       device="cpu")


def test_render_vjp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = load("cornell", res=(8, 8), depth=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.render_vjp(scene, np.ones((64, 3), np.float32), 1, 1)


def test_inverse_light_moves_toward_the_light():
    # the reference's own check of its loop (tests/test_examples.py:39-45,
    # 24x24, 2 spp, depth 2, 3 steps), on K8's plain version
    from pathtrace_tpu_torch.render.inverse import inverse_light

    errors = inverse_light(load("cornell", res=(24, 24), depth=2), steps=3,
                           spp=2, device="cpu")
    assert len(errors) == 4 and errors[-1] < errors[0]
