"""K1's plain PyTorch version against the reference's Pallas kernel.

The same packed tables (made by the port, handed over as numpy) go to the
reference's ``_run`` in interpret mode, every feature flag off, and to
``trace_plain``.  Bounds are those of ``tests/test_pallas.py``: under
0.5% of pixels may differ by more than 1e-3, and the live counts agree
within rtol 0.02.  The two libraries round sin/cos differently, and a
last-bit change at a geometry edge can flip which geom a ray hits (or
which lobe it takes), which changes that pixel's whole path: a discrete
tie flip, not drift, so it is bounded by a pixel share and not by a
tolerance on every pixel.

The CUDA kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``
(marker ``cuda``) holds it against ``trace_plain`` there and skips here.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import _run
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.core import types as T
from pathtrace_tpu_torch.ops.cuda import matgrad as MG
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import span as SP
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(name, res=None, depth=None):
    s = ptt.load_scene(os.path.join(REPO, "scenes", f"{name}.txt"))
    return dataclasses.replace(s, resolution=res or s.resolution,
                               trace_depth=depth or s.trace_depth)


def assert_tie_flip_bound(rad, ref_rad, counts, ref_counts):
    d = np.abs(np.asarray(rad) - np.asarray(ref_rad)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.005, (d > 1e-3).mean()
    np.testing.assert_allclose(np.asarray(counts), np.asarray(ref_counts),
                               rtol=0.02)


@pytest.mark.parametrize("name,res,depth", [
    ("cornell", (32, 32), 4),
    ("sphere", (32, 32), 4),
    # 960 pixels: not a multiple of the reference's 4096-ray tile, so its
    # valid mask and output crop are exercised
    ("cornell", (40, 24), 3),
])
def test_trace_plain_matches_pallas_kernel(name, res, depth):
    scene = _scene(name, res, depth)
    cam, mats, gmat = K.pack_scene(scene, "cpu")
    ref_rad, ref_counts = _run(
        cam.numpy(), mats.numpy(), gmat.numpy(), None, None,
        jnp.asarray(1, jnp.int32), res, depth, scene.geoms.type,
        interpret=True, n_spp=2, features=(False,) * 7)
    rad, counts = K.trace_plain(cam, mats, gmat, scene.geoms.type, *res,
                                depth, 1, 2)
    assert rad.shape == (res[0] * res[1], 3) and rad.dtype == torch.float32
    assert counts.dtype == torch.int64 and counts.shape == (depth,)
    assert int(counts[0]) == 2 * res[0] * res[1]
    assert_tie_flip_bound(rad, ref_rad, counts, ref_counts)


def test_trace_plain_pixel_range_and_chunks():
    # samples are keyed by the global pixel and the iteration, so a pixel
    # range starting at pix0 and chunks of samples tile the whole render
    scene = _scene("cornell", (24, 16), 3)
    tables = K.pack_scene(scene, "cpu")
    args = (scene.geoms.type, 24, 16, 3)
    whole, counts = K.trace_plain(*tables, *args, 5, 2)
    tail, _ = K.trace_plain(*tables, *args, 5, 2, pix0=100)
    assert torch.equal(tail, whole[100:])
    a, _ = K.trace_plain(*tables, *args, 5, 1)
    b, _ = K.trace_plain(*tables, *args, 6, 1)
    assert torch.equal(a + b, whole)


def test_trace_k1_on_cpu_is_the_plain_version():
    scene = _scene("cornell", (16, 16), 3)
    tables = K.pack_scene(scene, "cpu")
    before = K.LAUNCHES.copy()
    got = K.trace_k1(K.Job(*tables, scene.geoms.type, 16, 16, 3), 1, 2)
    want = K.trace_plain(*tables, scene.geoms.type, 16, 16, 3, 1, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.LAUNCHES == before


def _job(name, **kw):
    """A job of a small copy of ``name`` (8x8 d2) on the CPU."""
    return K.prepare(_scene(name, (8, 8), 2), "cpu", **kw)


def _meta(job, **change):
    """The job's first ``bvh_meta`` entry with fields changed."""
    entry = dict(zip(("g", "node_off", "n_nodes", "tri_off", "n_tris"),
                     job["bvh_meta"][0]), **change)
    return dict(bvh_meta=(tuple(entry.values()),) + job["bvh_meta"][1:])


def _remade(edit):
    """A case that makes the job again with the tables ``edit`` gives."""
    return lambda job: K.Job(**dict(job, **edit(job)))


def _span(job):
    keys = K.state_keys(job["features"], False)
    SP.trace_span(job, torch.zeros((len(keys), 64)), keys, 0, 1, 1,
                  torch.zeros(2, dtype=torch.int64))


def _k7(job):
    MG.trace_k7(job, torch.ones((1, MG.GRAD_ROWS)),
                (0,) * len(job["geom_types"]), torch.ones((64, 3)), 1, 1)


# case -> (the job's scene and prepare's options, what raises, the message)
REFUSALS = {
    "cam shape": (("cornell", {}), _remade(
        lambda j: dict(cam=j["cam"].reshape(16))), "cam: want"),
    "mats dtype": (("cornell", {}), _remade(
        lambda j: dict(mats=j["mats"].double())), "mats: want"),
    "mats not contiguous": (("cornell", {}), _remade(
        lambda j: dict(mats=j["mats"].t().contiguous().t())), "mats: want"),
    "gmat device": (("cornell", {}), _remade(
        lambda j: dict(gmat=j["gmat"].to("meta"))), "gmat: want"),
    "gmat rows": (("cornell", {}), _remade(
        lambda j: dict(gmat=j["gmat"][1:])), "gmat: want"),
    "lights shape": (("cornell", dict(nee=True)), _remade(
        lambda j: dict(lights=j["lights"][:, :64])), "lights: want"),
    "no lights": (("cornell", dict(nee=True)), _remade(
        lambda j: dict(lights=j["lights"][:0])), "bad scene"),
    "features": (("cornell", {}), _remade(
        lambda j: dict(features=j["features"][1:])), "bad scene"),
    "unknown geom type": (("cornell", {}), _remade(
        lambda j: dict(geom_types=(7,) + j["geom_types"][1:])),
        "unknown geom types"),
    "bvh_meta past the triangles": (("cornell_mesh", {}), _remade(
        lambda j: _meta(j, n_tris=j["tri"].shape[0] + 1)),
        "bad bvh_meta entry"),
    "bvh_meta past the nodes": (("cornell_mesh", {}), _remade(
        lambda j: _meta(j, node_off=j["nodes"].shape[0])),
        "bad bvh_meta entry"),
    "bvh_meta on a cube": (("cornell_mesh", {}), _remade(
        lambda j: _meta(j, g=j["geom_types"].index(T.CUBE))),
        "bad bvh_meta entry"),
    "mesh tables without bvh_meta": (("cornell_mesh", {}), _remade(
        lambda j: dict(bvh_meta=())), "without bvh_meta"),
    "tri columns": (("cornell_mesh", {}), _remade(
        lambda j: dict(tri=j["tri"][:, :12].contiguous())), "tri: want"),
    "texels without charts": (("cornell_tex", {}), _remade(
        lambda j: dict(tex_geom=(), btex_geom=())), "without tex_geom"),
    "charts without texels": (("cornell_tex", {}), _remade(
        lambda j: dict(texels=None)), "texels: want"),
    "texels dtype": (("cornell_tex", {}), _remade(
        lambda j: dict(texels=j["texels"].long())), "texels: want"),
    "chart past the texels": (("cornell_tex", {}), _remade(
        lambda j: dict(texels=j["texels"][:100])), "not inside a table"),
    "plain-only job on K1": (("cornell_tex", dict(texels="f32")),
                             lambda j: K.trace_k1(j, 1, 1),
                             "pack_textures_f32"),
    "plain-only job on K5": (("cornell_tex", dict(texels="f32")), _span,
                             "pack_textures_f32"),
    "plain-only job on K7": (("cornell_tex", dict(texels="f32")), _k7,
                             "pack_textures_f32"),
    "plain-only job on K8": (("cornell_tex", dict(texels="f32")),
                             lambda j: VJ.trace_k8(j, 1, 1,
                                                   torch.ones((64, 3))),
                             "pack_textures_f32"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_job_refuses(case):
    # the job checks its tables once, where it is made, on any device;
    # the launchers refuse a plain-only job before they reach the CPU
    (name, kw), act, match = REFUSALS[case]
    job = _job(name, **kw)
    with pytest.raises(ValueError, match=match):
        act(job)


def _same(a, b):
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, SimpleNamespace):
        return isinstance(b, SimpleNamespace) and _same(
            sorted(vars(a).items()), sorted(vars(b).items()))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name,kw", [
    ("cornell_mesh", dict(nee=True, rr=True)),
    ("cornell_tex", {}),
    ("cornell_tex", dict(texels="f32")),
])
def test_job_is_the_tables(name, kw):
    # a job holds the tables the pack_* functions give, under the keys
    # and in the forms the benchmark reads: trace_plain(**job),
    # plain_scene(**job), job[key]
    scene = _scene(name, (8, 8), 2)
    job = K.prepare(scene, "cpu", **kw)
    cam, mats, gmat = K.pack_scene(scene, "cpu")
    tri, nodes, bvh_meta = K.pack_mesh(scene, "cpu")
    tex_geom, btex_geom = K.tex_statics(scene)
    pack = (K.pack_textures_f32 if kw.get("texels") == "f32"
            else K.pack_textures)
    want = dict(
        cam=cam, mats=mats, gmat=gmat, geom_types=tuple(scene.geoms.type),
        width=8, height=8, depth=2, features=K.scene_features(scene),
        lights=K.pack_lights(scene, "cpu")[0] if kw.get("nee") else None,
        rr=kw.get("rr", False), tri=tri, nodes=nodes, bvh_meta=bvh_meta,
        texels=pack(scene, "cpu") if tex_geom or btex_geom else None,
        tex_geom=tex_geom, btex_geom=btex_geom)
    assert tuple(job) == tuple(want) and len(job) == 16
    for k in want:
        assert _same(job[k], want[k]), k
    got = K.trace_plain(**job, it0=2 ** 32 - 2, n_spp=2)
    assert _same(got, K.trace_plain(**want, it0=2 ** 32 - 2, n_spp=2))
    assert _same(K.plain_scene(**job), K.plain_scene(**want))
    assert len(job["geom_types"]) == len(scene.geoms.type)
    assert job["cam"].numel() == 16
    with pytest.raises(TypeError):
        job["cam"] = cam
    with pytest.raises(AttributeError):
        job.mask = 0


def _jax_scene(name, res=(8, 8), depth=2):
    """A scene loaded by the reference and carried over."""
    scene = convert.from_jax_scene(
        pt.load_scene(os.path.join(REPO, "scenes", f"{name}.txt")))
    return dataclasses.replace(scene, resolution=res, trace_depth=depth)


@pytest.mark.parametrize("name", [
    "cornell_bumpmesh", "cornell_tex", "cornell_bigmesh_tex"])
def test_off_grid_textures_raise(name):
    # a texture scene carried over from the reference passes the kernel's
    # check; the same scene with a map off the u8 grid is refused with a
    # ValueError (the reference sends such a map to another engine, which
    # the port does not have)
    scene = _jax_scene(name)
    K.prepare(scene, "cpu")
    rad, _ = K.pathtrace_batch_cuda(scene, 1, 1, device="cpu")
    assert bool(torch.isfinite(rad).all())
    used = K.tex_used(scene)[-1]
    off = list(scene.textures)
    off[used] = off[used] * np.float32(0.999)
    off_grid = dataclasses.replace(scene, textures=tuple(off))
    with pytest.raises(ValueError, match="u8 grid"):
        K.prepare(off_grid, "cpu")
    with pytest.raises(ValueError, match="u8 grid"):
        K.pathtrace_batch_cuda(off_grid, 1, 1, device="cpu")


@pytest.mark.parametrize("name", ["cornell_mesh", "cornell_bigmesh"])
def test_mesh_scenes_are_supported(name):
    # a mesh scene carried over from the reference, with its BVH, passes
    # the kernel's check and renders through the mesh build
    scene = _jax_scene(name)
    K.prepare(scene, "cpu")
    assert K.scene_mask(scene) == K.MESH_BIT
    rad, counts = K.pathtrace_batch_cuda(scene, 1, 2, device="cpu")
    assert rad.shape == (64, 3) and bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 64


@pytest.mark.parametrize("name,kw", [
    ("cornell_glass", {}), ("cornell_checker", {}),
    ("cornell", {"nee": True}), ("cornell", {"rr": True}),
    ("cornell_mesh", {"nee": True, "rr": True}),
])
def test_ported_paths_render(name, kw):
    rad, counts = K.pathtrace_batch_cuda(_scene(name, (8, 8), 4), 1, 2,
                                         device="cpu", **kw)
    assert rad.shape == (64, 3) and bool(torch.isfinite(rad).all())
    assert int(counts[0]) == 2 * 64 and counts.shape == (4,)


def test_cuda_device_without_gpu_raises(monkeypatch):
    # no silent fall back to the CPU when the GPU is missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        K.pathtrace_batch_cuda(_scene("cornell", (8, 8)), 1, 1,
                               device="cuda")

