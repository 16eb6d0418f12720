"""NEE (K2) in the port: the light tables, and the plain PyTorch
version's direct lighting against the reference's tracer.

Tables: ``pack_lights`` against the reference's ``_pack_lights`` within
1e-6 (the float32 rounding of the face areas' sums), and the per-light
geometry of ``ops/lights.py`` against the reference's.  Rendering: bounds
as in ``tests/test_torch_features.py``.  The reference's CPU build
reassociates and fuses some of the NEE term's products, so NEE pixels
agree to a few ulps rather than bit for bit.
"""

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops import lights as ref_lights
from pathtrace_tpu.ops.pallas.megakernel import _pack_lights
from pathtrace_tpu.render.integrator import geom_transforms
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops import lights
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from test_torch_features import check_against_reference
import torch_scenes as S


@pytest.mark.parametrize("name,edits", [
    ("cornell", ()), ("cornell_glass", ()), ("cornell_checker", ()),
    ("cornell", (S.SPHERE_LIGHT,)), ("sphere", ()),
])
def test_pack_lights_matches_reference(name, edits):
    text = S.scene_text(name, edits)
    want, want_statics = _pack_lights(pt.parse_scene(text))
    got, statics = K.pack_lights(S.load(name, edits), "cpu")
    assert statics == want_statics
    assert got.dtype == torch.float32 and got.shape == (len(statics), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    back = convert.lights_table_from_numpy(np.asarray(want), "cpu")
    assert back.dtype == torch.float32 and back.is_contiguous()
    assert back.shape == got.shape


def test_no_light_no_table():
    scene = S.load("cornell", (("EMITTANCE   5", "EMITTANCE   0"),))
    assert K.pack_lights(scene, "cpu") == (None, ())
    assert convert.lights_table_from_numpy(None, "cpu") is None
    # NEE without a light renders as without NEE, as the reference does
    job = K.prepare(scene, "cpu", nee=True)
    assert job["lights"] is None


def test_light_geometry_matches_reference():
    rs = np.random.default_rng(5)
    t = rs.uniform(-5, 5, (6, 3)).astype(np.float32)
    r = rs.uniform(-180, 180, (6, 3)).astype(np.float32)
    s = rs.uniform(0.1, 4, (6, 3)).astype(np.float32)
    geoms = pt.Geoms(type=np.zeros(6, np.int32),
                     material_id=np.zeros(6, np.int32), translation=t,
                     rotation=r, scale=s)
    fwd = np.array(geom_transforms(geoms)[0])  # writable, for torch
    for g in range(6):
        want = ref_lights.cube_light_tables(fwd[g], xp=np)
        got = lights.cube_light_tables(torch.as_tensor(fwd[g]))
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(
            float(lights.sphere_det3(torch.as_tensor(fwd[g]))),
            float(ref_lights.sphere_det3(fwd[g], xp=np)), rtol=1e-6)


@pytest.mark.parametrize("config", [
    "cornell-nee", "cornell_glass-nee", "sphere_light-nee"])
def test_nee_matches_planes(config):
    check_against_reference(config, (32, 32), 4, 2)


def test_nee_matches_pallas_interpret():
    check_against_reference("cornell-nee", (16, 16), 3, 1, interpret=True)


def test_nee_adds_direct_light():
    # same samples, with and without NEE: direct light is added at
    # bounces, and the paths (counts) are unchanged
    plain = S.job("cornell", (16, 16), 3)
    nee = S.job("cornell-nee", (16, 16), 3)
    rad, counts = K.trace_plain(**plain, it0=1, n_spp=1)
    rad_n, counts_n = K.trace_plain(**nee, it0=1, n_spp=1)
    assert torch.equal(counts, counts_n)
    assert not torch.equal(rad, rad_n)
