"""K3-linear, the fold of every triangle of a mesh without a BVH: the
port's plain version against the reference.

A mesh stripped of its BVH (``scene/bvh.without_bvh``) packs the linear
form (``pack_mesh``: the mesh's own triangle order, nodes None, one
``bvh_meta`` entry a run of one geom's triangles), and ``trace_plain``
folds every triangle in index order by world distance, as the
reference's ``tri_body`` does.  On cornell_mesh at 24x24 depth 3, with
and without NEE, it is held against the reference's planes engine with
``use_bvh=False`` and, without NEE, against ``pathtrace_batch_pallas(...,
interpret=True)`` on the stripped scene: the tie-flip bound (under 0.5%
of pixels off by more than 1e-3), the counts within 0.5%.  The linear
fold and the BVH walk find the same winners on the port's own trace.
The reference's linear fold leaves a mesh's BUMPTEX inert (flat
shading), and so does the port's: on cornell_bumpmesh the stripped
render is the reference's stripped render, and the same as with the
mesh's BUMPTEX strength at 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import pathtrace_batch_pallas
from pathtrace_tpu.render.plane_engine import pathtrace_batch_planes
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.scene.bvh import without_bvh

from torch_scenes import REPO

RES, DEPTH = (24, 24), 3


def _scenes(name, res=RES, depth=DEPTH):
    """(the reference's scene, the port's stripped of its BVH)."""
    js = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/{name}.txt"),
                             resolution=res, trace_depth=depth)
    return js, without_bvh(convert.from_jax_scene(js))


def _assert_tie_bound(rad, counts, ref, ref_counts):
    d = np.abs(rad.numpy() - np.asarray(ref)).max(-1)
    assert (d > 1e-3).mean() < 0.005, d.max()
    np.testing.assert_allclose(counts.numpy(), np.asarray(ref_counts),
                               rtol=0.005, atol=0)


def test_pack_mesh_linear_form():
    _, scene = _scenes("cornell_mesh")
    tri, nodes, meta = K.pack_mesh(scene, "cpu")
    assert nodes is None and tri.shape == (scene.mesh.count, K.TRI_COLS)
    # one run of the mesh geom's triangles, in the mesh's own order
    assert meta == ((6, 0, 0, 0, scene.mesh.count),)
    v = torch.as_tensor(np.asarray(scene.mesh.tri_verts))
    assert torch.equal(tri[:, :3], v[:, 0])
    assert torch.equal(tri[:, 3:6], v[:, 1] - v[:, 0])
    assert K.scene_mask(scene) == K.MESH_BIT | K.LINEAR_BIT


def test_pack_mesh_linear_runs_follow_tri_geom():
    # triangles of two geoms interleaved: one entry a run, in index order
    _, scene = _scenes("cornell_mesh")
    mesh = scene.mesh
    geom = np.asarray(mesh.tri_geom).copy()
    geom[5:9] = 4
    types = list(scene.geoms.type)
    types[4] = types[6]
    sc = dataclasses.replace(
        scene, mesh=dataclasses.replace(mesh, tri_geom=geom),
        geoms=dataclasses.replace(scene.geoms, type=tuple(types)))
    _, _, meta = K.pack_mesh(sc, "cpu")
    assert meta == ((6, 0, 0, 0, 5), (4, 0, 0, 5, 4), (6, 0, 0, 9, 11))


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_linear_fold_matches_reference_planes(nee):
    js, scene = _scenes("cornell_mesh")
    ref, ref_counts = pathtrace_batch_planes(js, 1, 2, nee=nee,
                                             use_bvh=False)
    rad, counts = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                                n_spp=2)
    _assert_tie_bound(rad, counts, ref, ref_counts)
    bvh, _ = K.trace_plain(**K.prepare(convert.from_jax_scene(js), "cpu",
                                       nee=nee), it0=1, n_spp=2)
    # and the linear fold finds the BVH walk's winners
    d = (rad - bvh).abs().amax(-1)
    assert float((d > 1e-3).float().mean()) < 0.005


def test_linear_fold_matches_reference_kernel_interpret():
    js, scene = _scenes("cornell_mesh", res=(16, 16))
    stripped = dataclasses.replace(js, mesh=dataclasses.replace(
        js.mesh, bvh_nodes=None, bvh_order=None, bvh_meta=()))
    ref, ref_counts = pathtrace_batch_pallas(stripped, 1, 1, interpret=True)
    rad, counts = K.trace_plain(**K.prepare(scene, "cpu"), it0=1, n_spp=1)
    _assert_tie_bound(rad, counts, ref, ref_counts)


def test_linear_fold_leaves_mesh_bumptex_flat():
    js, scene = _scenes("cornell_bumpmesh")
    ref, ref_counts = pathtrace_batch_planes(js, 1, 1, use_bvh=False)
    job = K.prepare(scene, "cpu")
    assert job["tex_geom"] == () and job["btex_geom"]
    # the linear form's UV gradients are zero: the map tilts no normal
    assert not bool(job["tri"][:, 18:24].any())
    rad, counts = K.trace_plain(**job, it0=1, n_spp=1)
    _assert_tie_bound(rad, counts, ref, ref_counts)
    # the same image as with the mesh's BUMPTEX strength at 0 ...
    mesh_mat = int(scene.geoms.material_id[6])
    m = scene.materials
    k = np.asarray(m.bumptex_strength).copy()
    k[mesh_mat] = 0.0
    flat = dataclasses.replace(scene, materials=dataclasses.replace(
        m, bumptex_strength=k))
    want, _ = K.trace_plain(**K.prepare(flat, "cpu"), it0=1, n_spp=1)
    d = (rad - want).abs().amax(-1)
    assert float((d > 1e-3).float().mean()) < 0.005
    # ... where the BVH's render tilts it
    bvh, _ = K.trace_plain(**K.prepare(convert.from_jax_scene(js), "cpu"),
                           it0=1, n_spp=1)
    assert float((rad - bvh).abs().max()) > 0.05
