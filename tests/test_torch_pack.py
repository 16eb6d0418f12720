"""The port's packed scene tables match the reference's ``_pack_scene``.

Tolerance: atol 1e-6, the float32 rounding of the ROTAT angles' sin/cos,
which the two libraries may round differently.
"""

import os

import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.core import vecmath as ref_vm
from pathtrace_tpu.ops.pallas.megakernel import _pack_scene
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.core import vecmath as vm
from pathtrace_tpu_torch.ops.cuda.megakernel import pack_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "name", ["cornell", "sphere", "cornell_glass", "cornell_checker"])
def test_pack_matches_reference(name):
    path = os.path.join(REPO, "scenes", f"{name}.txt")
    want = _pack_scene(pt.load_scene(path))[:3]
    got = pack_scene(ptt.load_scene(path), "cpu")
    for key, w, g in zip(("cam", "mats", "gmat"), want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, key
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=key)


def test_packed_tables_from_numpy_roundtrip():
    scene = ptt.load_scene(os.path.join(REPO, "scenes", "cornell.txt"))
    tables = pack_scene(scene, "cpu")
    back = convert.packed_tables_from_numpy(
        *(t.numpy() for t in tables), device="cpu")
    for a, b in zip(tables, back):
        assert b.dtype == torch.float32 and b.is_contiguous()
        assert torch.equal(a, b)


def test_trs_matches_reference():
    rs = np.random.default_rng(7)
    t = rs.uniform(-5, 5, (16, 3)).astype(np.float32)
    r = rs.uniform(-180, 180, (16, 3)).astype(np.float32)
    s = rs.uniform(0.01, 10, (16, 3)).astype(np.float32)
    args = [torch.as_tensor(a) for a in (t, r, s)]
    for ref_fn, fn in ((ref_vm.trs_matrix, vm.trs_matrix),
                       (ref_vm.trs_inverse, vm.trs_inverse)):
        want = np.asarray(ref_fn(t, r, s))
        got = fn(*args).numpy()
        assert got.dtype == np.float32
        # relative: entries reach 1/0.01 = 100, where sin/cos ulps scale
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("helper", ["pack_scene", "pack_lights", "pack_mesh",
                                    "pack_textures"])
def test_pack_helpers_default_to_the_card(monkeypatch, helper):
    # without a GPU the default device raises; no CPU tensors come back
    import pathtrace_tpu_torch.ops.cuda.megakernel as K

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = ptt.load_scene(os.path.join(REPO, "scenes", "cornell_tex.txt"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        getattr(K, helper)(scene)


@pytest.mark.parametrize("helper,args", [
    ("packed_tables_from_numpy", (np.zeros((1, 16)), np.zeros((1, 24)),
                                  np.zeros((1, 40)))),
    ("lights_table_from_numpy", (None,)),
    ("mesh_tables_from_numpy", (np.zeros((1, 16)), np.zeros((1, 16))))])
def test_convert_defaults_to_the_card(monkeypatch, helper, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        getattr(convert, helper)(*args)
