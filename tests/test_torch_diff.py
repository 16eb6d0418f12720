"""The differentiable scene packing and ``render/diff.py`` of the port.

``pack_scene``/``pack_lights`` of a scene whose parameters are tensors
that require grad (``split_params``, ``requires_grad``,
``merge_params``) give the same bits as the packing of the plain arrays,
and their vector-Jacobian products match ``jax.vjp`` of the reference's
``_pack_scene``/``_pack_lights`` on the same cotangents.  Tolerance: rtol
and atol 1e-5, the float32 rounding of the ROTAT angles' sin/cos and of
the two libraries' orders of summation.
"""

import jax
import numpy as np
import pytest
import torch

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import _pack_lights, _pack_scene
from pathtrace_tpu.render import diff as JD
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import diff as D
import pathtrace_tpu_torch as ptt

from torch_scenes import REPO, SPHERE_LIGHT, scene_text

# (scene file, variants): a cube light, and a sphere light
SCENES = {"cornell": ("cornell", ()),
          "sphere_light": ("cornell", (SPHERE_LIGHT,))}


def _scenes(name):
    text = scene_text(*SCENES[name])
    return (pt.parse_scene(text, base_dir=f"{REPO}/scenes"),
            ptt.parse_scene(text, base_dir=f"{REPO}/scenes"))


def _torch_pack(scene, fn):
    params = D.requires_grad(D.split_params(scene))
    return params, fn(D.merge_params(scene, params))


PACKERS = {
    "pack_scene": (lambda s: _pack_scene(s)[:3],
                   lambda s: K.pack_scene(s, "cpu")),
    "pack_lights": (lambda s: (_pack_lights(s)[0],),
                    lambda s: (K.pack_lights(s, "cpu")[0],)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("packer", sorted(PACKERS))
def test_packing_keeps_its_bits_and_graph(name, packer):
    _, scene = _scenes(name)
    _, fn = PACKERS[packer]
    plain = fn(scene)
    params, tables = _torch_pack(scene, fn)
    for a, b in zip(plain, tables):
        assert b.requires_grad and b.grad_fn is not None
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("packer", sorted(PACKERS))
def test_packing_vjp_matches_reference(name, packer):
    js, scene = _scenes(name)
    ref_fn, fn = PACKERS[packer]
    params, tables = _torch_pack(scene, fn)
    rs = np.random.RandomState(3)
    cts = [rs.standard_normal(t.shape).astype(np.float32) for t in tables]
    torch.autograd.backward(tables, [torch.as_tensor(c) for c in cts])
    got = dict(D.named_leaves(D.grads(params)))

    _, vjp = jax.vjp(lambda p: ref_fn(JD.merge_params(js, p)),
                     JD.split_params(js))
    want = dict(D.named_leaves(vjp(tuple(cts))[0]))
    assert set(got) == set(want)
    for name, w in want.items():
        assert bool(torch.isfinite(got[name]).all()), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_split_merge_round_trip():
    _, scene = _scenes("cornell")
    params = D.split_params(scene)
    assert tuple(params) == D.KEYS
    back = D.merge_params(scene, params)
    for a, b in zip(D.leaves(params), D.leaves(D.split_params(back))):
        assert a is b
    assert (back.geoms.type, back.resolution, back.light_indices) == (
        scene.geoms.type, scene.resolution, scene.light_indices)
    # the tensor leaves come back as they were put in
    tparams = D.requires_grad(params)
    again = D.split_params(D.merge_params(scene, tparams))
    for a, b in zip(D.leaves(tparams), D.leaves(again)):
        assert a is b
    names = [n for n, _ in D.named_leaves(params)]
    assert names == [n for n, _ in D.named_leaves(tparams)]
    for a, b in zip(D.leaves(params), D.leaves(tparams)):
        assert b.dtype == torch.float32 and b.requires_grad
        assert np.array_equal(np.asarray(a, np.float32), b.detach().numpy())


def test_as_f32_keeps_a_tensor_and_its_graph():
    from pathtrace_tpu_torch.core.vecmath import as_f32

    x = torch.tensor([1.0, 2.0], requires_grad=True)
    assert as_f32(x) is x
    y = as_f32(x.double())
    assert y.dtype == torch.float32 and y.grad_fn is not None
    assert as_f32(np.arange(3)).dtype == torch.float32
