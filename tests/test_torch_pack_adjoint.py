"""The packing's adjoint, written by hand, against the autograd chain.

``render_vjp`` packs its tables with no autograd graph and carries K8's
table gradients to the parameters of ``split_params`` through
``ops/cuda/pack_adjoint.pack_adjoint``.  Its oracle is the chain it ran
before: the parameters as leaves that require grad, ``pack_scene`` and
``pack_lights`` under autograd and ``torch.autograd.backward``
(``torch_gradcheck.autograd_chain``), in float32 as it ran and in
float64, the truth the adjoint (float64) is nearer.  Random cotangents
on every table
of every case of ``test_torch_pack_batched`` (random TRS on a cube or a
sphere light: both signs of scale, scales down to 0.01), the mesh, bump
and SSS scenes, and a geom flattened to zero on one axis and to a
negative hair on another (where the inverse's eps decides the sign);
every leaf within ``torch_gradcheck.CHAIN_TOL``, the same leaves None,
zeros where the oracle's are.  The transmission push's gradient is
split evenly among an axis's tied largest scales, as ``torch.amax``
splits it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.core.constants import TRANSMISSION_PUSH
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda.pack_adjoint import pack_adjoint

import torch_gradcheck as GC
import torch_scenes as S
from test_torch_pack_batched import CASES, _scene

# a wall of cornell.txt (OBJECT 1, SCALE 10 .01 10) and its light
# (OBJECT 0, SCALE 3 .3 3)
WALL, LIGHT = 1, 0


def _case(case):
    if case == "cornell_mesh":
        return S.load("cornell_mesh")
    if case in ("bump", "sss"):
        return S.load("cornell_glass", (S.BUMP if case == "bump" else S.SSS,))
    if case == "flat":
        scene = S.load("cornell")
        scale = np.array(scene.geoms.scale, np.float32)
        scale[WALL] = (0.0, -1e-13, 2.0)
        return dataclasses.replace(scene, geoms=dataclasses.replace(
            scene.geoms, scale=scale))
    return _scene(case)


def _tables(scene):
    tables = list(K.pack_scene(scene, "cpu"))
    lights = K.pack_lights(scene, "cpu")[0]
    return tables + ([] if lights is None else [lights])


@pytest.mark.parametrize("case", CASES + ["cornell_mesh", "bump", "sss",
                                          "flat"])
def test_adjoint_matches_the_autograd_chain(case):
    scene = _case(case)
    rs = np.random.default_rng(sum(map(ord, case)))
    cts = [torch.as_tensor(rs.standard_normal(t.shape).astype(np.float32))
           for t in _tables(scene)]
    # with the light table, and without it, as render_vjp chains without
    # NEE; against the chain in float32 and in float64
    for tables in (cts, cts[:3]):
        got = pack_adjoint(scene, *tables)
        for dtype in (torch.float32, torch.float64):
            want = GC.autograd_chain(scene, tables, dtype)
            assert GC.chain_misses(got, want) == [], dtype
        assert (got["tri_verts"] is None) == bool(scene.mesh.count)


def test_push_splits_evenly_among_tied_scales():
    # the push, TRANSMISSION_PUSH max|s|, on the wall (10 .01 10), on
    # the light (3 .3 3) and on the light turned to (-3 3 2): sign(s) at
    # the largest |s|, halved between the two
    scene = S.load("cornell")
    scale = np.array(scene.geoms.scale, np.float32)
    scale[LIGHT] = (-3.0, 3.0, 2.0)
    for sc, g, want in ((scene, WALL, (0.5, 0.0, 0.5)),
                        (scene, LIGHT, (0.5, 0.0, 0.5)),
                        (dataclasses.replace(scene, geoms=dataclasses.replace(
                            scene.geoms, scale=scale)), LIGHT,
                         (-0.5, 0.5, 0.0))):
        cts = [torch.zeros_like(t) for t in _tables(sc)]
        cts[2][g, 36] = 1.0
        got = pack_adjoint(sc, *cts)
        assert GC.chain_misses(got, GC.autograd_chain(
            sc, cts, torch.float64)) == []
        expect = torch.zeros_like(got["scale"])
        expect[g] = TRANSMISSION_PUSH * torch.tensor(want)
        torch.testing.assert_close(got["scale"], expect, rtol=1e-6, atol=0)
