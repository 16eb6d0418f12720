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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import _run
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K

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
    got = K.trace_k1(*tables, scene.geoms.type, 16, 16, 3, 1, 2)
    want = K.trace_plain(*tables, scene.geoms.type, 16, 16, 3, 1, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.LAUNCHES == before


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
    K.check_supported(scene)
    rad, _ = K.pathtrace_batch_cuda(scene, 1, 1, device="cpu")
    assert bool(torch.isfinite(rad).all())
    used = K.tex_used(scene)[-1]
    off = list(scene.textures)
    off[used] = off[used] * np.float32(0.999)
    off_grid = dataclasses.replace(scene, textures=tuple(off))
    with pytest.raises(ValueError, match="u8 grid"):
        K.check_supported(off_grid)
    with pytest.raises(ValueError, match="u8 grid"):
        K.pathtrace_batch_cuda(off_grid, 1, 1, device="cpu")


@pytest.mark.parametrize("name", ["cornell_mesh", "cornell_bigmesh"])
def test_mesh_scenes_are_supported(name):
    # a mesh scene carried over from the reference, with its BVH, passes
    # the kernel's check and renders through the mesh build
    scene = _jax_scene(name)
    K.check_supported(scene)
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

