"""The port's scene model and parser give what the reference's give."""

import dataclasses
import os

import numpy as np
import pytest

import pathtrace_tpu as pt
from pathtrace_tpu.scene.obj import load_obj as ref_load_obj
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.scene.obj import load_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIMITIVE_SCENES = ["cornell", "sphere", "cornell_glass", "cornell_checker"]


def _scene_path(name):
    return os.path.join(REPO, "scenes", f"{name}.txt")


def assert_same(ref, got, path="scene"):
    """Field by field: arrays equal in value and dtype, statics equal."""
    if dataclasses.is_dataclass(ref):
        names = [f.name for f in dataclasses.fields(ref)]
        assert names == [f.name for f in dataclasses.fields(got)], path
        for n in names:
            assert_same(getattr(ref, n), getattr(got, n), f"{path}.{n}")
    elif ref is None or isinstance(ref, (str, int, float)):
        assert ref == got, path
    elif isinstance(ref, tuple) and not (
            ref and isinstance(ref[0], np.ndarray)):
        assert tuple(ref) == tuple(got), path
    elif isinstance(ref, tuple):  # arrays of their own shapes (textures)
        assert isinstance(got, tuple) and len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same(r, g, f"{path}[{i}]")
    else:
        r, g = np.asarray(ref), np.asarray(got)
        assert r.dtype == g.dtype and r.shape == g.shape, path
        np.testing.assert_array_equal(r, g, err_msg=path)


@pytest.mark.parametrize("name", PRIMITIVE_SCENES)
def test_load_scene_matches_reference(name):
    assert_same(pt.load_scene(_scene_path(name)),
                ptt.load_scene(_scene_path(name)))


@pytest.mark.parametrize("name", PRIMITIVE_SCENES)
def test_from_jax_scene_matches_own_load(name):
    assert_same(ptt.load_scene(_scene_path(name)),
                convert.from_jax_scene(pt.load_scene(_scene_path(name))))


@pytest.mark.parametrize("name", [
    "cornell_tex", "cornell_bumpmesh", "cornell_bigmesh_tex"])
def test_texture_scenes_match_reference(name):
    # the maps, their ids per material and the BUMPTEX strengths (the
    # mesh scenes' BVHs: tests/test_torch_bvh.py)
    scene = ptt.load_scene(_scene_path(name))
    assert scene.textures
    assert_same(pt.load_scene(_scene_path(name)), scene)


def test_parse_every_primitive_keyword():
    text = """
MATERIAL 0
RGB 1 .5 .25
SPECEX 8
SPECRGB .1 .2 .3
REFL .5
REFR 1
REFRIOR 1.33
EMITTANCE 0
CHECKER 4 .1 .2 .3
BUMP 2 .5
SSS 3 .9 .8 .7

MATERIAL 1
RGB 1 1 1
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
EMITTANCE 2

CAMERA
RES 64 48
FOVY 30
ITERATIONS 7
DEPTH 3
FILE kw
EYE 1 2 3
VIEW 0 0 -1
UP 0 1 0
APERTURE .2
FOCAL 9

OBJECT 0
sphere
material 0
TRANS 1 2 3
ROTAT 10 20 30
SCALE 2 2 2
MOTION .5 0 0

OBJECT 1
cube
material 1
TRANS 0 9 0
ROTAT 0 0 0
SCALE 3 .3 3
"""
    assert_same(pt.parse_scene(text), ptt.parse_scene(text))


@pytest.mark.parametrize("obj", ["icosahedron.obj", "gridplane.obj"])
def test_obj_loader_matches_reference(obj):
    path = os.path.join(REPO, "scenes", obj)
    (rv, ruv), (gv, guv) = ref_load_obj(path), load_obj(path)
    np.testing.assert_array_equal(rv, gv)
    assert (ruv is None) == (guv is None)
    if ruv is not None:
        np.testing.assert_array_equal(ruv, guv)
