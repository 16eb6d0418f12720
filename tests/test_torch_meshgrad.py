"""K8's mesh builds and K7 on meshes: the port's plain versions against
the reference.

``render_vjp(..., device="cpu")`` (autograd over the plain trace with the
mesh tables constants, chained through the packing) against the
gradient of the reference's planes engine with ``bvh_grad=True`` (the
BVH walk detached, the winner's hit recomputed; ``jax.vjp`` at the
cotangent), on the mesh rig of the
reference's ``tests/test_vjp_kernel.py`` (a light, a floor and an
icosahedron, 12x12 depth 2), with NEE and without: every parameter group
but ``tri_verts`` to rtol 2e-4 / atol 3e-4, the reference's tolerance,
with the tie-flipped pixels masked out of the cotangent as in
``test_torch_vjp.masked_ct``; ``tri_verts`` is None, as the reference's
``render_vjp_pallas`` gives on a mesh.  Every gradient is finite.

``material_grads(device="cpu")`` on the same rig (8x8, depth 2) against
``material_grads_pallas(..., interpret=True)``, which reaches the
reference's grad-mode kernel through the BVH walk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import (
    _scene_features, material_grads_pallas,
)
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu.render.plane_engine import _batch_jit_planes
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import matgrad as MG
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.render import diff as D

from test_torch_vjp import ATOL, RTOL, grad_groups, masked_ct
from torch_scenes import REPO, mesh_rig_text


def mesh_rig(res=None):
    """(the reference's mesh rig of ``tests/test_vjp_kernel.py``, the
    port's), at ``res`` (its own 12x12 by default)."""
    js = pt.parse_scene(mesh_rig_text().replace("scenes/",
                                                f"{REPO}/scenes/"))
    if res is not None:
        js = dataclasses.replace(js, resolution=res)
    return js, convert.from_jax_scene(js)


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def mesh_case(request):
    """(nee, port scene, ct, the reference's gradients) on the mesh rig."""
    nee = request.param
    js, scene = mesh_rig()
    assert scene.mesh.count and scene.mesh.bvh_meta
    feat = _scene_features(js)

    def fwd(params):
        rad, _ = _batch_jit_planes(JD.merge_params(js, params), 1, 1, feat,
                                   nee, False, (), (), (), bvh_grad=True)
        return rad

    # the gradient of sum(ct * rad) is the VJP of the forward at ct
    rad_ref, vjp_fn = jax.vjp(fwd, JD.split_params(js))
    rad, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                           n_spp=1)
    ct = masked_ct(rad_ref, rad.numpy())
    (gref,) = vjp_fn(jnp.asarray(ct))
    return nee, scene, ct, gref


def test_render_vjp_on_a_mesh_matches_reference(mesh_case):
    nee, scene, ct, gref = mesh_case
    _, g = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    assert g["tri_verts"] is None
    got = grad_groups(g)
    want = grad_groups(gref)
    del want["tri_verts"]
    assert set(got) == set(want)
    if nee:
        # the NEE term carries the geometry: its gradients are not zero
        assert np.abs(want["translation"]).max() > 0.1
    for name in sorted(want):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_render_vjp_on_a_mesh_returns_the_plain_radiance(mesh_case):
    nee, scene, ct, _ = mesh_case
    rad, g = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
    assert tuple(g) == D.KEYS


def test_k8_wrapper_on_cpu_mesh_tables_is_the_plain_version():
    _, scene = mesh_rig(res=(8, 8))
    job = K.prepare(scene, "cpu", nee=True)
    ct = torch.rand((64, 3), generator=torch.Generator().manual_seed(3))
    before = sum(VJ.LAUNCHES.values())
    got, want = VJ.trace_k8(job, 1, 1, ct), VJ.k8_plain(job, 1, 1, ct)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert sum(VJ.LAUNCHES.values()) == before
    # the mesh takes part: as constants, not as a missing geom
    bare = VJ.k8_plain(K.Job(**dict(job, tri=None, nodes=None,
                                    bvh_meta=())), 1, 1, ct)
    assert not torch.equal(bare[0], want[0])


def test_material_grads_on_a_mesh_matches_reference():
    js, scene = mesh_rig(res=(8, 8))
    n_pix = js.pixel_count
    ct = np.random.RandomState(4).rand(n_pix, 3).astype(np.float32)
    rk, gk = material_grads_pallas(js, ct, 1, 1, interpret=True)
    rad, g = MG.material_grads(scene, ct, 1, 1, device="cpu")
    np.testing.assert_allclose(rad.numpy(), np.asarray(rk), rtol=0,
                               atol=1e-4)
    assert float(g["color"].abs().max()) > 0
    for key in g:
        # the reference's tolerance for cornell (tests/test_grad_kernel.py)
        np.testing.assert_allclose(g[key].numpy(), np.asarray(gk[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
