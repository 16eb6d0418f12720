"""The port's BVH builder, mesh loader and packed mesh tables against the
JAX package's: the tree (nodes, triangle order, per-geom entries) and the
loaded scenes bit-equal; the packed ``tri``/``nodes`` tables within 1e-6
of ``_pack_scene``'s.  Of those, the nodes and the v0/e1/e2 columns are
bit-equal; the unit normals differ in the last bit on about a quarter of
the triangles, because XLA's CPU build contracts the cross product's
``a*b - c*d`` into fused multiply-adds and the port does not."""

import dataclasses
import os

import numpy as np
import pytest

import pathtrace_tpu as pt
from pathtrace_tpu.core import types as RT
from pathtrace_tpu.ops.pallas.megakernel import _pack_scene
from pathtrace_tpu.scene import bvh as ref_bvh
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.core import types as T
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.scene import bvh
from pathtrace_tpu_torch.scene.obj import load_obj
from test_torch_scene import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_SCENES = ["cornell_mesh", "cornell_bigmesh"]


def _scene_path(name):
    return os.path.join(REPO, "scenes", f"{name}.txt")


def _rand_tris(n, seed=0):
    # tests/test_bvh.py's random soups
    r = np.random.RandomState(seed)
    base = r.rand(n, 1, 3) * 8 - 4
    return (base + r.rand(n, 3, 3) * 0.5).astype(np.float32)


def _soup(name):
    """(tri_verts, tri_geom, geom_count) of a named triangle soup."""
    if name == "rand333":
        return _rand_tris(333), np.zeros(333, np.int32), 1
    if name == "rand100":
        return _rand_tris(100, seed=3), np.zeros(100, np.int32), 1
    if name == "offsets":  # tests/test_bvh.py test_per_geom_offsets
        tv = np.concatenate([_rand_tris(40), _rand_tris(25, 1)])
        return tv, np.array([0] * 40 + [2] * 25, np.int32), 3
    # two instances of the icosahedron, geoms 6 and 7
    tv, _ = load_obj(os.path.join(REPO, "scenes", "icosahedron.obj"))
    tg = np.array([6] * len(tv) + [7] * len(tv), np.int32)
    return np.concatenate([tv, tv]), tg, 8


@pytest.mark.parametrize("obj", ["icosahedron.obj", "gridplane.obj",
                                 "icosphere6.obj"])
def test_build_geom_bvh_matches_reference(obj):
    tv, _ = load_obj(os.path.join(REPO, "scenes", obj))
    nodes, order = bvh.build_geom_bvh(tv)
    ref_nodes, ref_order = ref_bvh.build_geom_bvh(tv)
    assert nodes.dtype == ref_nodes.dtype and order.dtype == ref_order.dtype
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(order, ref_order)


@pytest.mark.parametrize("soup", ["rand333", "rand100", "offsets",
                                  "two_instances"])
def test_build_mesh_bvh_matches_reference(soup):
    tv, tg, count = _soup(soup)
    nodes, order, meta = bvh.build_mesh_bvh(tv, tg, count)
    ref_nodes, ref_order, ref_meta = ref_bvh.build_mesh_bvh(tv, tg, count)
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(order, ref_order)
    assert meta == ref_meta
    # with_bvh fills the same fields on the two packages' meshes
    got = bvh.with_bvh(T.TriMesh(tri_verts=tv, tri_geom=tg), count)
    want = ref_bvh.with_bvh(RT.TriMesh(tri_verts=tv, tri_geom=tg), count)
    assert_same(want, got)
    assert bvh.with_bvh(got, count) is got  # built once


@pytest.mark.parametrize("name", MESH_SCENES)
def test_load_mesh_scene_matches_reference(name):
    # the native parser where the reference has it, and its Python path
    got = ptt.load_scene(_scene_path(name))
    assert_same(pt.load_scene(_scene_path(name)), got)
    assert_same(pt.load_scene(_scene_path(name), native=False), got)
    assert got.mesh.bvh_meta and got.geoms.type[6] == T.MESH


@pytest.mark.parametrize("name", MESH_SCENES)
def test_pack_mesh_matches_reference(name):
    scene = ptt.load_scene(_scene_path(name))
    tri, nodes, meta = K.pack_mesh(scene, "cpu")
    _, _, _, ref_tri, ref_nodes = _pack_scene(pt.load_scene(_scene_path(name)))
    ref_tri, ref_nodes = np.asarray(ref_tri), np.asarray(ref_nodes)
    assert tri.shape == ref_tri.shape == (scene.mesh.count, K.TRI_COLS)
    np.testing.assert_allclose(tri.numpy(), ref_tri, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tri.numpy()[:, :9], ref_tri[:, :9])
    np.testing.assert_array_equal(nodes.numpy(), ref_nodes)
    assert meta == scene.mesh.bvh_meta
    # the reference's tables carried over
    c_tri, c_nodes = convert.mesh_tables_from_numpy(ref_tri, ref_nodes,
                                                    "cpu")
    assert c_tri.dtype == tri.dtype and c_tri.shape == tri.shape
    assert (c_tri[:, :9] == tri[:, :9]).all() and (c_nodes == nodes).all()


def test_pack_mesh_without_triangles():
    scene = ptt.load_scene(_scene_path("cornell"))
    assert K.pack_mesh(scene, "cpu") == (None, None, ())
    mesh = ptt.load_scene(_scene_path("cornell_mesh"))
    stripped = dataclasses.replace(mesh, mesh=dataclasses.replace(
        mesh.mesh, bvh_nodes=None, bvh_order=None, bvh_meta=()))
    # a mesh without a BVH packs K3-linear's form: no nodes, the rows in
    # the mesh's own order (tests/test_torch_linear.py)
    tri, nodes, meta = K.pack_mesh(stripped, "cpu")
    assert nodes is None and meta == ((6, 0, 0, 0, mesh.mesh.count),)
    assert tri.shape == (mesh.mesh.count, K.TRI_COLS)
