"""The plain version's float texel table (``megakernel.pack_textures_f32``,
``prepare(..., texels="f32")``): the planes engine's texels.

On maps on the u8 grid it gives the word path's bits (byte k is the IEEE
quotient k/255, the loader's texel value, and ``_bilin3`` gathers at the
same indices).  A map off the grid renders on the planes engine, equal to
the reference's planes engine within the tie bound (under 0.5% of pixels
off by more than 1e-3), and still raises on K1's route: the kernels read
bytes, and refuse a float table rather than convert it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.render.plane_engine import pathtrace_batch_planes
from pathtrace_tpu_torch import cli, convert
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import span as SP
from pathtrace_tpu_torch.render import diff as D
from pathtrace_tpu_torch.scene import textures as TX

from torch_scenes import REPO, load

TIE_SHARE = 0.005


@pytest.mark.parametrize("name", ["cornell_tex", "cornell_bumpmesh"])
@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_float_table_gives_the_word_paths_bits(name, nee):
    scene = load(name, res=(24, 20), depth=3)
    words = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                          n_spp=2, per_sample=True)
    floats = K.trace_plain(**K.prepare(scene, "cpu", nee=nee, texels="f32"),
                           it0=1, n_spp=2, per_sample=True)
    assert torch.equal(floats[0], words[0])
    assert torch.equal(floats[1], words[1])


def test_pack_textures_f32_is_the_maps_in_table_order():
    scene = load("cornell_bumpmesh")
    tab = K.pack_textures_f32(scene, "cpu")
    assert tab.dtype == torch.float32 and tab.shape[1] == 3
    for t, (off, h, w) in K.tex_offsets(scene).items():
        np.testing.assert_array_equal(
            tab[off:off + h * w].numpy(),
            np.asarray(scene.textures[t]).reshape(-1, 3))
    words = K.pack_textures(scene, "cpu").to(torch.int64)
    for c in range(3):
        assert torch.equal(torch.round(tab[:, c] * 255).to(torch.int64),
                           (words >> (8 * c)) & 255)
    assert K.pack_textures_f32(load("cornell"), "cpu") is None


def test_pack_textures_f32_keeps_a_maps_graph():
    scene = load("cornell_tex", res=(8, 8), depth=2)
    tid = scene.texture_ids[5]
    tex = torch.tensor(np.asarray(scene.textures[tid]), requires_grad=True)
    scene = dataclasses.replace(scene, textures=tuple(
        tex if i == tid else t for i, t in enumerate(scene.textures)))
    tab = K.pack_textures_f32(scene, "cpu")
    assert tab.requires_grad
    tab.sum().backward()
    assert torch.equal(tex.grad, torch.ones_like(tex))


def off_grid(textures):
    """The maps moved off the u8 grid (every texel)."""
    return tuple((np.asarray(t, np.float32) * np.float32(0.9)
                  + np.float32(0.0013)) for t in textures)


def test_off_grid_map_renders_on_the_planes_engine():
    js = dataclasses.replace(pt.load_scene(f"{REPO}/scenes/cornell_tex.txt"),
                             resolution=(32, 32), trace_depth=3)
    js = dataclasses.replace(js, textures=off_grid(js.textures))
    scene = convert.from_jax_scene(js)
    with pytest.raises(ValueError, match="off the u8 grid"):
        K.prepare(scene, "cpu")
    want, _ = pathtrace_batch_planes(js, 1, 2, nee=True)
    got = D.render_mean(scene, 1, 2, nee=True, engine="planes",
                        device="cpu") * 2
    d = np.abs(got.numpy() - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < TIE_SHARE
    on_grid = D.render_mean(convert.from_jax_scene(dataclasses.replace(
        js, textures=pt.load_scene(f"{REPO}/scenes/cornell_tex.txt")
        .textures)), 1, 2, nee=True, engine="planes", device="cpu") * 2
    assert not torch.equal(got, on_grid)


def test_off_grid_map_still_raises_on_k1():
    scene = load("cornell_tex", res=(8, 8), depth=2)
    scene = dataclasses.replace(scene, textures=off_grid(scene.textures))
    with pytest.raises(ValueError, match="--engine planes"):
        K.prepare(scene, "cpu")
    with pytest.raises(ValueError, match="--engine planes"):
        K.pathtrace_batch_cuda(scene, 1, 1, device="cpu")


def test_kernels_refuse_a_float_table():
    scene = load("cornell_tex", res=(8, 8), depth=2)
    job = K.prepare(scene, "cpu", texels="f32")
    with pytest.raises(ValueError, match="pack_textures_f32"):
        K.trace_k1(job, 1, 1)
    state = torch.zeros((len(K.state_keys(job["features"], False)), 64))
    with pytest.raises(ValueError, match="pack_textures_f32"):
        SP.trace_span(job, state, K.state_keys(job["features"], False), 0,
                      2, 1, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="texels must be one of"):
        K.prepare(scene, "cpu", texels="f16")


def test_cli_engine_planes_renders_an_off_grid_map(monkeypatch, tmp_path):
    # a PNG decodes onto the u8 grid; a loader that moves it off the grid
    # stands for a map the reference's planes engine renders
    load_texture = TX.load_texture
    monkeypatch.setattr(TX, "load_texture",
                        lambda p: off_grid([load_texture(p)])[0])
    scene_file = os.path.join(REPO, "scenes", "cornell_tex.txt")
    args = [scene_file, "--device", "cpu", "--res", "16", "16", "--depth",
            "2", "--spp", "1", "--out", str(tmp_path / "t.png")]
    assert cli.main(args + ["--engine", "planes"]) == 0
    assert (tmp_path / "t.png").exists()
    with pytest.raises(ValueError, match="--engine planes"):
        cli.main(args)
