"""The port's native host runtime (``pathtrace_tpu_torch/native/``: the
C++ scene parser, OBJ loader and PNG/HDR writers, built by g++ at first
use) against the port's Python paths and the reference's loaders, as
``tests/test_native.py`` holds the reference's.

``scenes/cornell_hugemesh.txt`` needs ``scenes/gen_icosphere7.obj``,
which is generated (``tools/gen_mesh.py 7``) and not committed: its case
skips where the file is absent."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

import pathtrace_tpu as pt
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.io import image_io
from pathtrace_tpu_torch.native import lib as N
from pathtrace_tpu_torch.scene import parser as SP
from pathtrace_tpu_torch.scene.obj import load_obj

from test_torch_scene import assert_same
from torch_scenes import tree_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(os.path.basename(p)[:-4]
                for p in glob.glob(os.path.join(REPO, "scenes", "*.txt")))


@pytest.mark.parametrize("name", SCENES)
def test_scene_parses_as_the_python_parser_and_the_reference(name):
    path = os.path.join(REPO, "scenes", f"{name}.txt")
    if name == "cornell_hugemesh" and not os.path.exists(
            os.path.join(REPO, "scenes", "gen_icosphere7.obj")):
        pytest.skip("scenes/gen_icosphere7.obj is generated, not committed "
                    "(python tools/gen_mesh.py 7 scenes/gen_icosphere7.obj)")
    got = ptt.load_scene(path, native=True)
    tree_equal(got, SP.load_scene(path, native=False))
    assert_same(pt.load_scene(path, native=False), got)


def test_load_scene_takes_the_native_path(monkeypatch):
    path = os.path.join(REPO, "scenes", "cornell.txt")
    calls = []
    parse = N.parse_scene_native

    def spy(**kw):
        calls.append(kw)
        return parse(**kw)

    monkeypatch.setattr(N, "parse_scene_native", spy)
    ptt.load_scene(path)
    ptt.load_scene(path, native=True)
    assert calls == [dict(path=path)] * 2
    ptt.load_scene(path, native=False)
    monkeypatch.setenv("PT_NO_NATIVE", "1")
    ptt.load_scene(path)
    assert len(calls) == 2
    with pytest.raises(N.NativeError, match="PT_NO_NATIVE"):
        ptt.load_scene(path, native=True)


def test_errors_match_the_python_parser():
    text = open(os.path.join(REPO, "scenes", "cornell.txt")).read()
    with pytest.raises(SP.SceneParseError, match="OBJECT ID"):
        N.parse_scene_native(text=text.replace("OBJECT 3", "OBJECT 9", 1))
    with pytest.raises(SP.SceneParseError, match="OBJECT ID"):
        SP.parse_scene(text.replace("OBJECT 3", "OBJECT 9", 1))
    with pytest.raises(FileNotFoundError):
        N.parse_scene_native(path="/nonexistent/scene.txt")


def test_mesh_scene_from_text(tmp_path):
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                      "vt 0 0\nvt 1 0\nvt 0 1\n"
                                      "f 1/1 2/2 3/3\n")
    txt = (open(os.path.join(REPO, "scenes", "sphere.txt")).read()
           + "\nOBJECT 1\nmesh tri.obj\nmaterial 0\n"
           "TRANS 0 0 0\nROTAT 0 0 0\nSCALE 1 1 1\n")
    got = N.parse_scene_native(text=txt, base_dir=str(tmp_path))
    assert got.mesh.count == 1 and got.mesh.tri_uv is not None
    tree_equal(got, SP.parse_scene(txt, base_dir=str(tmp_path)))


def test_obj_loader_matches_the_python_loader(tmp_path):
    obj = tmp_path / "m.obj"
    obj.write_text("# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\r\n"
                   "f 1 2 3 4\nf -4/1 -3/2 -2/3\n")
    tris, uvs = load_obj(str(obj))
    np.testing.assert_array_equal(N.load_obj_native(str(obj)), tris)
    assert uvs is None  # vt slots without a vt block: no UV table
    for name in ("icosahedron", "gridplane"):
        path = os.path.join(REPO, "scenes", f"{name}.obj")
        np.testing.assert_array_equal(N.load_obj_native(path),
                                      load_obj(path)[0])


def test_obj_loader_errors(tmp_path):
    with pytest.raises(N.NativeError, match="cannot open"):
        N.load_obj_native("/nonexistent.obj")
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nf 1 2 7\n")
    with pytest.raises(N.NativeError, match="out of range"):
        N.load_obj_native(str(bad))


def test_png_round_trip(tmp_path):
    rgb = np.random.RandomState(0).randint(0, 256, (33, 47, 3), np.uint8)
    N.write_png_native(str(tmp_path / "n.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "n.png")),
                                  rgb)


def test_save_png_native_and_pillow_decode_equal(tmp_path):
    img = np.random.RandomState(4).uniform(-0.2, 1.3, (9, 14, 3))
    image_io.save_png(str(tmp_path / "n.png"), img, native=True)
    image_io.save_png(str(tmp_path / "p.png"), img, native=False)
    assert (tmp_path / "n.png").read_bytes() != \
        (tmp_path / "p.png").read_bytes()  # two encoders
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "n.png")),
                                  np.asarray(Image.open(tmp_path / "p.png")))


def test_hdr_bytes_equal_the_python_writer(tmp_path):
    img = np.abs(np.random.RandomState(1).randn(9, 13, 3)).astype(np.float32)
    img[0, 0] = [7.5, 0.2, 0.01]
    img[1, 1] = 0.0
    N.write_hdr_native(str(tmp_path / "n.hdr"), img)
    image_io.save_hdr(str(tmp_path / "p.hdr"), img)
    assert (tmp_path / "n.hdr").read_bytes() == \
        (tmp_path / "p.hdr").read_bytes()


def test_native_true_raises_without_a_compiler(tmp_path, monkeypatch):
    # a fresh build directory and no compiler: native=True raises, the
    # default falls back to the Python paths
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_error", None)
    path = os.path.join(REPO, "scenes", "cornell.txt")
    with pytest.raises(N.NativeError, match="no-such-g"):
        ptt.load_scene(path, native=True)
    with pytest.raises(N.NativeError, match="unavailable"):
        image_io.save_png(str(tmp_path / "x.png"), np.zeros((2, 2, 3)),
                          native=True)
    assert not N.available()
    tree_equal(ptt.load_scene(path), SP.load_scene(path, native=False))
    image_io.save_png(str(tmp_path / "y.png"), np.zeros((2, 2, 3)))
    assert (tmp_path / "y.png").exists()
    assert not list((tmp_path / "build").glob("*.so"))
