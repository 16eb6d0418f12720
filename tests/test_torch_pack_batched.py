"""The batched scene packing against the packing one element at a time.

``pack_scene`` and ``pack_lights`` build ``cam``, ``mats``, ``gmat`` and
``lights`` in a few tensor ops over all geoms, faces and light rows; the
oracle ``tests/torch_pack_ref.py`` builds them entry by entry, as the
reference's ``_pack_scene``/``_pack_lights`` are written.  Every sum keeps
its order and nothing is fused, so the tables are equal bit for bit, with
and without parameters that require grad; the gradients the two graphs
give the parameters agree to rounding (autograd may add a leaf's
contributions in another order); and the graph stays small, the cost of
``render_vjp``'s packing and chain.  The shared helpers are held to the
oracle's forms on general per-ray tensors, on the CPU and (the ``cuda``
case) on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.core import vecmath as vm
from pathtrace_tpu_torch.ops import lights as L
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.render import diff as D
from pathtrace_tpu_torch.render.integrator import geom_transforms

import torch_pack_ref as R
import torch_scenes as S

# the light's geom of cornell.txt (OBJECT 0), a cube; a sphere under
# SPHERE_LIGHT
LIGHT = 0
N_TRS = 16


def _trs(i):
    """Random TRS triple ``i``: rotations in +-180 degrees, scales of
    0.01-10 in size and of either sign."""
    rs = np.random.default_rng(100 + i)
    scale = rs.uniform(0.01, 10, 3) * rs.choice([-1.0, 1.0], 3)
    return (rs.uniform(-5, 5, 3), rs.uniform(-180, 180, 3), scale)


def _scene(case):
    """The scene of ``case``: a scene file, cornell with a sphere light or
    with every geom moving, or cornell with random TRS triple ``i`` on its
    light (a cube for even ``i``, a sphere for odd)."""
    if case.startswith("trs"):
        i = int(case[3:])
        scene = S.load("cornell", (S.SPHERE_LIGHT,) if i % 2 else ())
        g = scene.geoms
        fields = {}
        for name, value in zip(("translation", "rotation", "scale"),
                               _trs(i)):
            arr = np.array(getattr(g, name), dtype=np.float32)
            arr[LIGHT] = value
            fields[name] = arr
        return dataclasses.replace(scene,
                                   geoms=dataclasses.replace(g, **fields))
    if case == "sphere_light":
        return S.load("cornell", (S.SPHERE_LIGHT,))
    if case == "motion":
        scene = S.load("cornell")
        vel = np.random.default_rng(9).uniform(
            -1, 1, (len(scene.geoms.type), 3)).astype(np.float32)
        return dataclasses.replace(
            scene, geoms=dataclasses.replace(scene.geoms, velocity=vel))
    return S.load(case)


def _tables(pack, pack_lights, scene):
    return list(pack(scene)) + [pack_lights(scene)[0]]


def _new(scene):
    return _tables(lambda s: K.pack_scene(s, "cpu"),
                   lambda s: K.pack_lights(s, "cpu"), scene)


def _old(scene):
    return _tables(R.pack_scene, R.pack_lights, scene)


def _with_leaves(scene):
    """(params, the scene on them): every ``split_params`` leaf a tensor
    that requires grad, as ``render_vjp`` packs."""
    params = D.requires_grad(D.split_params(scene))
    return params, D.merge_params(scene, params)


def _graph(tables):
    """The autograd nodes reachable from ``tables``' ``grad_fn``s."""
    seen, todo = set(), [t.grad_fn for t in tables]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo += [g for g, _ in f.next_functions]
    return seen


CASES = (["cornell", "sphere", "cornell_glass", "cornell_checker",
          "sphere_light", "motion"] + [f"trs{i}" for i in range(N_TRS)])


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "grad"])
@pytest.mark.parametrize("case", CASES)
def test_batched_pack_keeps_the_oracles_bits(case, grad):
    scene = _scene(case)
    if grad:
        _, scene = _with_leaves(scene)
    new, old = _new(scene), _old(scene)
    for name, a, b in zip(("cam", "mats", "gmat", "lights"), new, old):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
        # the signs of zeros too
        assert torch.equal(torch.signbit(a), torch.signbit(b)), name
        if grad:
            assert a.requires_grad and a.grad_fn is not None, name
    for a, b in zip(geom_transforms(scene.geoms),
                    R.geom_transforms(scene.geoms)):
        assert torch.equal(a, b) and torch.equal(torch.signbit(a),
                                                 torch.signbit(b))
    if case.startswith("trs"):
        t, r, s = (torch.as_tensor(np.float32(x))
                   for x in _trs(int(case[3:])))
        for fn, ref in ((vm.trs_matrix, R.trs_matrix),
                        (vm.trs_inverse, R.trs_inverse)):
            assert torch.equal(fn(t, r, s), ref(t, r, s))
        fwd = vm.trs_matrix(t, r, s)
        want = R.cube_light_tables(fwd)
        got = L.cube_light_tables(fwd)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert torch.equal(L.sphere_det3(fwd), R.sphere_det3(fwd))


@pytest.mark.parametrize("name", ["cornell", "cornell_glass"])
def test_batched_pack_chain_matches_the_oracle(name):
    # NEE: the light table in the chain, as the inverse step packs it
    scene = S.load(name)
    params_new, sc_new = _with_leaves(scene)
    params_old, sc_old = _with_leaves(scene)
    new, old = _new(sc_new), _old(sc_old)
    rs = np.random.default_rng(11)
    cts = [torch.as_tensor(rs.standard_normal(t.shape).astype(np.float32))
           for t in new]
    torch.autograd.backward(new, cts)
    torch.autograd.backward(old, cts)
    got = dict(D.named_leaves(D.grads(params_new)))
    want = dict(D.named_leaves(D.grads(params_old)))
    assert set(got) == set(want)
    for leaf, w in want.items():
        assert bool(torch.isfinite(got[leaf]).all()), leaf
        np.testing.assert_allclose(got[leaf].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=leaf)
    assert float(torch.abs(got["rotation"]).max()) > 0


def test_packed_graph_stays_small():
    # per-element packing gave this graph 1,391 nodes; the batched one
    # under 200, which bounds the host time of render_vjp's chain
    _, scene = _with_leaves(S.load("cornell"))
    tables = _new(scene)
    assert all(t.grad_fn is not None for t in tables)
    assert len(_graph(tables)) <= 200


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_shared_helpers_keep_the_oracles_bits(device):
    # general matrices and vectors, per-ray sized: in a rotation one of
    # each entry's three terms is zero, which hides a reordered sum
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this case holds the helpers there")
    g = torch.Generator().manual_seed(5)

    def draw(*shape, lo=-2.0, hi=2.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(device)

    m, a, v = draw(4096, 3, 3), draw(4096, 3, 3), draw(4096, 3)
    w, one = draw(4096, 3), draw(3, 3)
    for got, want in (
            (vm.mat3_mat(m, a), R.mat3_mat(m, a)),
            (vm.mat3_vec(m, v), R.mat3_vec(m, v)),
            (vm.mat3_vec(one, v), R.mat3_vec(one, v)),
            (vm.cross(v, w), R.cross(v, w)),
            (vm.dot(v, w), R.dot(v, w)),
            (vm.normalize(v), R.normalize(v))):
        assert torch.equal(got, want)
    t, r, s = draw(64, 3), draw(64, 3, lo=-180, hi=180), draw(64, 3, hi=10)
    for fn, ref in ((vm.trs_matrix, R.trs_matrix),
                    (vm.trs_inverse, R.trs_inverse)):
        assert torch.equal(fn(t, r, s), ref(t, r, s))
    fwd = vm.trs_matrix(t[0], r[0], s[0])
    want = R.cube_light_tables(fwd)
    for key, got in L.cube_light_tables(fwd).items():
        assert torch.equal(got, want[key]), key
    scene = S.load("cornell")
    for got, want in zip(_tables(lambda s: K.pack_scene(s, device),
                                 lambda s: K.pack_lights(s, device), scene),
                         _old(scene)):
        assert got.device.type == device and torch.equal(got.cpu(), want)
