"""Image textures (K4) on the host: the port's loader, sampler, chart
polynomials and tables against the reference's.

Maps and samples are compared bit for bit; the packed triangle table
within 1e-6 (XLA's CPU build contracts the cross product and the Gram
sums into fused multiply-adds, which moves a last bit).  The traced
images are in ``test_torch_tex_trace.py``, ``test_torch_tex512.py`` and
``test_torch_tex_mesh.py``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.intersect import (
    triangle_uv_gradients as ref_triangle_uv_gradients,
)
from pathtrace_tpu.ops.pallas import megakernel as mk
from pathtrace_tpu.scene import textures as ref_textures
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render.integrator import triangle_uv_gradients
from pathtrace_tpu_torch.scene import textures
from pathtrace_tpu_torch.scene.obj import load_obj
import torch_scenes as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEX_DIR = os.path.join(REPO, "scenes", "tex")
MAPS = ["pattern32.png", "bumps16.png", "pattern512.png"]
TEX_SCENES = ["cornell_tex", "cornell_bumpmesh", "cornell_bigmesh_tex"]


def _scenes(name):
    path = os.path.join(REPO, "scenes", f"{name}.txt")
    return pt.load_scene(path), ptt.load_scene(path)


@pytest.mark.parametrize("name", MAPS)
def test_load_texture_matches_reference(name):
    path = os.path.join(TEX_DIR, name)
    want, got = ref_textures.load_texture(path), textures.load_texture(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_texture_clamps_its_side(tmp_path, monkeypatch):
    # past MAX_TEX_SIDE the map is LANCZOS-downsampled, as the reference's
    from PIL import Image

    rng = np.random.default_rng(3)
    path = str(tmp_path / "big.png")
    Image.fromarray(rng.integers(0, 256, (40, 24, 3), np.uint8)).save(path)
    monkeypatch.setattr(textures, "MAX_TEX_SIDE", 16)
    monkeypatch.setattr(ref_textures, "MAX_TEX_SIDE", 16)
    got = textures.load_texture(path)
    assert got.shape == (16, 10, 3)
    np.testing.assert_array_equal(got, ref_textures.load_texture(path))


@pytest.mark.parametrize("name", MAPS[:2])
def test_sample_texture_matches_reference(name):
    tex = textures.load_texture(os.path.join(TEX_DIR, name))
    h, w = tex.shape[:2]
    rng = np.random.default_rng(7)
    u = rng.uniform(-2.0, 3.0, 4000).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, 4000).astype(np.float32)
    # every texel centre, and both sides of the wrap seam
    cu, cv = np.meshgrid(((np.arange(w) + 0.5) / w).astype(np.float32),
                         ((np.arange(h) + 0.5) / h).astype(np.float32))
    seam = np.array([0.0, 1.0, -0.0, 1e-7, 1.0 - 1e-7, 0.5 / w, -0.5 / w,
                     2.0, -1.0], np.float32)
    u = np.concatenate([u, cu.ravel(), seam])
    v = np.concatenate([v, cv.ravel(), seam[::-1]])
    want = ref_textures.sample_texture(tex, u, v, xp=np)
    got = textures.sample_texture(tex, torch.from_numpy(u),
                                  torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_texel_centres_sample_the_texels():
    tex = textures.load_texture(os.path.join(TEX_DIR, "pattern32.png"))
    iy, ix = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    u = torch.from_numpy(((ix + 0.5) / 32).astype(np.float32))
    v = torch.from_numpy(((iy + 0.5) / 32).astype(np.float32))
    np.testing.assert_array_equal(
        textures.sample_texture(tex, u, v).numpy(), tex)


def _chart_edges():
    """The reference's atan2 edge points (tests/test_textures.py) and a
    grid with its diagonals, axes and signed zeros."""
    pts = np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [-1, 1],
                    [-1, -1], [1, -1], [1e-20, 1], [1, 1e-20], [0, 0],
                    [-0.0, 0], [0, -0.0], [-0.0, -0.0]], np.float32)
    g = np.linspace(-1.0, 1.0, 81, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    rng = np.random.default_rng(11)
    rand = rng.normal(size=(4000, 2)).astype(np.float32)
    return np.concatenate([pts, grid, rand, rand * 1e-3]).astype(np.float32)


def test_atan2_is_the_reference_polynomial():
    # the reference's polynomial, op by op (eager, as its kernel writes
    # it), bit for bit; never libm's atan2
    xy = _chart_edges()
    want = np.asarray(mk._atan2(xy[:, 1], xy[:, 0]))
    got = K._atan2(torch.from_numpy(xy[:, 1]), torch.from_numpy(xy[:, 0]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy()[:10],
                               np.arctan2(xy[:10, 1], xy[:10, 0]), atol=1e-6)


def test_asin_is_the_reference_polynomial():
    t = np.concatenate([np.linspace(-1.0, 1.0, 4001, dtype=np.float32),
                        np.array([-1.0, -0.0, 0.0, 1.0, 1e-20, -1e-20,
                                  0.9999999, -0.9999999], np.float32)])
    want = np.asarray(mk._asin(t))
    got = K._asin(torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.arcsin(t), atol=2e-6)


def test_sphere_chart_matches_the_reference_under_jit():
    # the chart as the reference's kernel computes it (jitted: XLA may
    # fuse), against the port's, on points of the unit sphere
    rng = np.random.default_rng(5)
    q = rng.normal(size=(5000, 3)).astype(np.float32)
    q = (0.5 * q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
        np.float32)

    @jax.jit
    def ref_uv(qx, qy, qz):
        return (0.5 + mk._atan2(qz, qx) * np.float32(1.0 / (2 * np.pi)),
                0.5 + mk._asin(jax.numpy.clip(2.0 * qy, -1.0, 1.0))
                * np.float32(1.0 / np.pi))

    want = [np.asarray(x) for x in ref_uv(*q.T)]
    got = K._sphere_uv(*torch.from_numpy(q).unbind(1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-7)


@pytest.mark.parametrize("name", TEX_SCENES)
def test_tex_tables_match_reference(name):
    ref, scene = _scenes(name)
    assert K.tex_used(scene) == mk._tex_used(ref)
    assert K.tex_offsets(scene) == mk._tex_offsets(ref)
    assert K.tex_spec(scene) == mk._tex_spec(ref)
    assert K.btex_spec(scene) == mk._btex_spec(ref)
    tg, used, bg = mk._tex_statics(ref)
    assert K.tex_statics(scene) == (tg, bg) and used == K.tex_used(scene)


@pytest.mark.parametrize("name", TEX_SCENES)
def test_pack_textures_decodes_to_reference_texels(name):
    ref, scene = _scenes(name)
    words = K.pack_textures(scene, "cpu")
    assert words.dtype == torch.int32 and words.dim() == 1
    w = words.numpy().astype(np.int64)
    assert int(w.max()) < 1 << 24
    tables = mk._pack_textures(ref, mk._tex_used(ref))
    packed = mk._pack_textures(ref, mk._tex_used(ref), packed=True)
    for c in range(3):
        byte = (w >> (8 * c)) & 255
        np.testing.assert_array_equal(
            byte.astype(np.float32) / np.float32(255.0),
            np.asarray(tables[c]).reshape(-1)[:len(w)])
        # the reference kernel's u8 words hold the same bytes
        quads = np.asarray(packed[c]).view(np.uint32).reshape(-1)
        shifts = 8 * (np.arange(len(w)) % 4)
        np.testing.assert_array_equal(
            (quads[np.arange(len(w)) // 4] >> shifts) & 255, byte)


@pytest.mark.parametrize("name", ["cornell_bumpmesh", "cornell_bigmesh_tex"])
def test_pack_mesh_texture_columns_match_reference(name):
    ref, scene = _scenes(name)
    tg, _, bg = mk._tex_statics(ref)
    _, _, _, ref_tri, _ = mk._pack_scene(ref, tg, bg)
    tri, nodes, meta = K.pack_mesh(scene, "cpu")
    assert tuple(tri.shape) == tuple(ref_tri.shape) == (scene.mesh.count, 24)
    np.testing.assert_allclose(tri.numpy(), np.asarray(ref_tri), rtol=0,
                               atol=1e-6)
    # the vt columns are copied, bit for bit
    np.testing.assert_array_equal(tri.numpy()[:, 12:18],
                                  np.asarray(ref_tri)[:, 12:18])


def test_pack_mesh_without_textures_keeps_16_columns():
    tri, _, _ = K.pack_mesh(S.load("cornell_mesh"), "cpu")
    assert tri.shape[1] == K.TRI_COLS


@pytest.mark.parametrize("soup", ["gridplane", "random"])
def test_triangle_uv_gradients_match_reference(soup):
    if soup == "gridplane":
        tv, uv = load_obj(os.path.join(REPO, "scenes", "gridplane.obj"))
    else:
        rng = np.random.default_rng(2)
        tv = rng.normal(size=(3000, 3, 3)).astype(np.float32)
        uv = rng.uniform(-2, 3, size=(3000, 3, 2)).astype(np.float32)
        tv[:5, 2] = tv[:5, 0]   # zero-area faces: zero gradients
    got = triangle_uv_gradients(tv, uv)
    want = ref_triangle_uv_gradients(tv, uv, xp=np)
    eager = ref_triangle_uv_gradients(tv, uv)  # jnp, one op at a time
    for g, w, e in zip(got, want, eager):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
        # the sums in the reference's order: bit-equal to its jnp form
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    if soup == "random":
        assert not got[0][:5].any() and not got[1][:5].any()


def test_off_grid_texture_raises_value_error():
    scene = S.load("cornell_tex")
    bad = list(scene.textures)
    bad[0] = bad[0] + np.float32(0.001)
    scene = dataclasses.replace(scene, textures=tuple(bad))
    with pytest.raises(ValueError, match="u8 grid"):
        K.pack_textures(scene, "cpu")
    with pytest.raises(ValueError, match="u8 grid"):
        K.prepare(scene, "cpu")


def test_unused_textures_stay_out_of_the_tables():
    # a map no geom uses is neither packed nor checked (_tex_used)
    scene = S.load("cornell_tex")
    mid = np.asarray(scene.geoms.material_id).copy()
    mid[mid == 6] = 1   # the BUMPTEX sphere becomes diffuse white
    scene = dataclasses.replace(
        scene, geoms=dataclasses.replace(scene.geoms, material_id=mid))
    bad = list(scene.textures)
    bad[1] = bad[1] + np.float32(0.001)
    scene = dataclasses.replace(scene, textures=tuple(bad))
    assert K.tex_used(scene) == (0,)
    assert K.tex_statics(scene)[1] == ()
    assert K.pack_textures(scene, "cpu").numel() == 32 * 32


@pytest.mark.parametrize("name,bits", [
    ("cornell_tex", K.TEX_BIT | K.BTEX_BIT),
    ("cornell_bumpmesh", K.MESH_BIT | K.BTEX_BIT),
    ("cornell_bigmesh_tex", K.MESH_BIT | K.TEX_BIT),
])
def test_texture_scene_masks(name, bits):
    scene = S.load(name)
    K.prepare(scene, "cpu")
    assert K.scene_mask(scene) == bits
    assert K.scene_mask(scene, nee=True) == bits | K.NEE_BIT


def test_scan_and_attach_match_reference():
    text = S.scene_text("cornell_tex", (S.TEX512,))
    assert textures.scan_texture_lines(text) == \
        ref_textures.scan_texture_lines(text)
    # two materials naming one file share one map
    twice = text.replace("BUMPTEX     tex/bumps16.png 0.6",
                         "BUMPTEX     tex/pattern512.png 0.6")
    scene = ptt.parse_scene(twice, base_dir=os.path.join(REPO, "scenes"))
    assert len(scene.textures) == 1
    assert scene.texture_ids[5] == scene.bump_texture_ids[6] == 0
