"""The reference holds to the program's plain versions at a tiny size on
the CPU: the same tables, the same radiance and counts bit for bit
(``trace_plain``), both mesh walks, on the benchmark's configurations and
on two with glass, an imperfect specular sphere and a thin lens
(``tiny.glass_config``), and the light's gradient of an image loss within
float32 rounding of the port's ``render_vjp`` on the CPU (autograd over
``trace_plain``, the plain K8).  The reference itself imports nothing of
the program; these tests do."""

from __future__ import annotations

import ast
import json

import pytest
import torch

from benchmark.harness import scenes
from benchmark.reference import tables as RT
from benchmark.reference import tracer as RTR
from benchmark.tests import tiny

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp

CONFIGS = ("cornell", "cornell_bigmesh", "cornell_glass",
           "cornell_bigmesh_glass")


def _scene(tmp_path, name):
    """The tiny configuration ``name`` (a benchmark configuration, or
    one with ``_glass`` after its name: ``tiny.glass_config`` of it), its
    OBJ paths and the program's scene of it."""
    root = tiny.make_root(tmp_path, res=(24, 16), depth=4)
    base = name.removesuffix("_glass")
    cfg = json.loads((root / "benchmark" / "configs" /
                      f"{base}.json").read_text())
    if name != base:
        cfg = tiny.glass_config(cfg)
    path, objs = scenes.write_scene(cfg, tmp_path / "scene")
    return cfg, objs, ptt.load_scene(path)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_plain_version(tmp_path, name, nee):
    cfg, objs, scene = _scene(tmp_path, name)
    job = K.prepare(scene, "cpu", nee=nee)
    want, want_c = K.trace_plain(**job, it0=2 ** 32 - 2, n_spp=3)
    tab = RT.pack(RT.scene_from_config(cfg, objs), nee=nee)
    for k in ("cam", "mats", "gmat", "lights", "tri", "nodes"):
        assert (tab[k] is None) == (job[k] is None), k
        if tab[k] is not None:
            assert torch.equal(tab[k], job[k]), k
    assert tab["bvh_meta"] == job["bvh_meta"]
    assert tab["features"] == job["features"][:3]
    assert any(tab["features"]) == name.endswith("_glass")
    for walk in ("skip", "frontier"):
        rad, counts = RTR.trace(tab, 2 ** 32 - 2, 3, walk=walk)
        assert torch.equal(rad, want), walk
        assert torch.equal(counts, want_c), walk
    # one path a (iteration, pixel) pair, the samples summed after
    n = scene.pixel_count
    its = (2 ** 32 - 2 + torch.arange(3))[:, None].expand(3, n).reshape(-1)
    pix = torch.arange(n)[None].expand(3, n).reshape(-1)
    rad, counts = RTR.trace_paths(tab, its, pix, block=100)
    assert torch.equal(counts, want_c)
    torch.testing.assert_close(rad.reshape(3, n, 3).sum(0), want,
                               rtol=1e-6, atol=1e-6)


def test_light_gradient_is_the_plain_vjp(tmp_path):
    cfg, objs, scene = _scene(tmp_path, "cornell")
    light, spp, it0 = 0, 2, 5
    ct = torch.rand((scene.pixel_count, 3), generator=torch.Generator()
                    .manual_seed(0))
    _, g = vjp.render_vjp(scene, ct, it0, spp, nee=True, device="cpu")
    rs = RT.scene_from_config(cfg, objs)
    t = rs.translations().requires_grad_(True)
    rad = RTR.trace(RT.pack(rs, translation=t, nee=True), it0, spp)[0]
    (rad * ct).sum().backward()
    torch.testing.assert_close(t.grad[light], g["translation"][light],
                               rtol=1e-4, atol=1e-6)
    assert float(t.grad[light].abs().max()) > 0


@pytest.mark.parametrize("name", ("cornell", "cornell_glass",
                                  "cornell_bigmesh_glass"))
def test_control_differs(tmp_path, name):
    cfg, objs, _ = _scene(tmp_path, name)
    tab = RT.pack(RT.scene_from_config(cfg, objs))
    rad, _ = RTR.trace(tab, 1, 2)
    low, _ = RTR.trace(tab, 1, 2, dtype=torch.bfloat16)
    assert float((low.double() - rad.double()).abs().sum()
                 / rad.double().abs().sum()) > 1e-2


def test_reference_imports_nothing_of_the_program():
    ref = tiny.REPO / "benchmark" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "sys", "types",
                                           "dataclasses", "contextlib",
                                           "collections", "__future__"), \
                    (path.name, n)
