"""The gradient holds of ``tests/torch_gradcheck.py``: the term
magnitudes of a backward pass (``AbsTerms``), the float64 reading, the
same-path mask, the per-entry bounds and the packing's chain.  No JAX."""

import pytest
import torch

import torch_gradcheck as GC
import torch_scenes as S
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ


def test_abs_terms_sums_the_magnitudes_of_cancelling_terms():
    x = torch.tensor([2.0, -3.0], dtype=torch.float64, requires_grad=True)
    a = torch.tensor([5.0, 7.0], dtype=torch.float64)

    def f():
        # d/dx: a - a / 2 - a / 2 + (-a) - (-a) = 0, from terms of |a|,
        # |a|/2, |a|/2, |a|, |a|
        y = x * a - x * a / 2.0 - (x / 2.0) * a
        return y + (-x) * a - (-(x * a))

    (g,) = torch.autograd.grad(f(), x, torch.ones(2, dtype=torch.float64))
    mode = GC.AbsTerms()
    with mode:
        (m,) = torch.autograd.grad(f(), x,
                                   torch.ones(2, dtype=torch.float64))
    assert torch.equal(g, torch.zeros(2, dtype=torch.float64))
    assert torch.allclose(m, 4.0 * a) and mode.calls > 0


@pytest.mark.parametrize("config", ["cornell-nee", "cornell_mesh-nee"])
def test_terms_bound_every_pixels_part(config):
    # an entry's term magnitude (the backward on absolute values, which
    # chain_bound takes) is at least the sum over pixels of each pixel's
    # part of the gradient (and at least the gradient); the float64
    # reading is the sum of the pixels' parts
    job = S.job(config, (5, 4), 3)
    n = job["width"] * job["height"]
    tables = [job["cam"], job["mats"], job["gmat"], job["lights"]]

    def trace(cam, mats, gmat, lights):
        return K.trace_plain(cam, mats, gmat, job["geom_types"],
                             job["width"], job["height"], job["depth"], 1, 1,
                             lights=lights, tri=job["tri"],
                             nodes=job["nodes"], bvh_meta=job["bvh_meta"])[0]

    ct = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    rad64, grads = GC.reading64(trace, tables)
    w64 = grads(ct)
    leaf = [t.double().requires_grad_(True) for t in tables]
    rad = trace(*leaf)
    with GC.AbsTerms():
        mags = torch.autograd.grad(rad, leaf, ct.double().abs())
    rad32, _ = VJ.k8_plain(job, 1, 1, ct)
    assert bool(GC.same_paths(rad32, rad64).all())
    parts = [torch.zeros_like(t, dtype=torch.float64) for t in tables]
    sums = [torch.zeros_like(t, dtype=torch.float64) for t in tables]
    for p in range(n):
        c = torch.zeros_like(ct)
        c[p] = ct[p]
        for acc, tot, g in zip(parts, sums, GC.reading64(trace, tables)[1](c)):
            acc += g.abs()
            tot += g
    for w, m, part, tot in zip(w64, mags, parts, sums):
        assert w.dtype == m.dtype == torch.float64
        assert bool((m >= w.abs() * (1 - 1e-6)).all())
        assert bool((m >= part * (1 - 1e-6)).all())
        # (the trace rounds its draws in float32, each batch its own way)
        assert torch.allclose(tot, w, rtol=1e-5,
                              atol=1e-5 * float(w.abs().max()))
    assert float(mags[2].max()) > 10.0 * float(w64[2].abs().max())


def test_same_paths_marks_pixels_that_part():
    rad32 = torch.tensor([[1.0, 2.0, 3.0], [10.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    rad64 = rad32.double() + torch.tensor([[1e-6, 0.0, 0.0],
                                           [5e-3, 0.0, 0.0],
                                           [0.0, 0.0, 2e-4]],
                                          dtype=torch.float64)
    assert GC.same_paths(rad32, rad64).tolist() == [True, False, False]


def test_compare_own_allows_twice_the_plain_versions_float32_error():
    w = torch.tensor([100.0, 1.0, 0.5])
    w64 = torch.tensor([100.01, 1.0, 0.5], dtype=torch.float64)
    rtol, atol = GC.K8_TOL
    room = atol + rtol * w.double() + 2.0 * (w.double() - w64).abs()

    def row(g):
        return GC.compare_own([("t", g)], [("t", w)], [("t", w64)], rtol,
                              atol)[0]

    assert row(w + 0.9 * room.float())[-1]
    # an entry the plain version has right gets only the bare tolerance
    assert not row(w + torch.tensor([0.0, 2.0 * float(room[1]), 0.0]))[-1]
    name, scale, err, ratio, need, share, ok = row(
        w + torch.tensor([float(room[0]) * 1.5, 0.0, 0.0]))
    assert (name, scale, ok) == ("t", 100.0, False)
    assert ratio == pytest.approx(1.5, rel=1e-3) and need > 2.0
    assert share == pytest.approx(2e-4, rel=1e-3)
    assert not row(torch.tensor([100.0, float("inf"), 0.5]))[-1]


def test_compare_own_fails_a_limit_wider_than_its_table():
    # a float64 reading that far from the plain version's allows any
    # answer: the row is a miss even for the plain version's own
    rtol, atol = GC.K8_TOL
    w = torch.tensor([1.0, -2.0, 0.5])
    for w64, share, ok in (([1.0, -2.5, 0.5], 0.5, True),
                           ([1.0, 0.5, 0.5], 2.5, False)):
        row = GC.compare_own([("t", w)], [("t", w)],
                             [("t", torch.tensor(w64, dtype=torch.float64))],
                             rtol, atol)[0]
        assert row[5] == pytest.approx(share) and row[-1] is ok
    # an all-zero table with a float64 reading that is not
    row = GC.compare_own([("t", 0 * w)], [("t", 0 * w)],
                         [("t", torch.ones(3, dtype=torch.float64))],
                         rtol, atol)[0]
    assert row[5] == float("inf") and not row[-1]


def test_chain_bound_carries_the_tables_bound_to_the_parameters():
    # render_vjp's parameter gradients are the packing's backward of the
    # tables': a bound on the tables' gradients bounds theirs, through the
    # packing's Jacobian taken on absolute values
    scene = S.load("cornell_glass", res=(8, 8), depth=2)
    job = K.prepare(scene, "cpu", nee=True)
    tables = [job["cam"], job["mats"], job["gmat"], job["lights"]]
    gen = torch.Generator().manual_seed(4)
    tol = [torch.rand(t.shape, generator=gen) for t in tables]
    bound = dict(GC.chain_bound(scene, True, tol))
    assert set(bound) >= {"translation", "scale", "camera.aperture",
                          "materials.ior"}
    assert all(bool((b >= 0).all()) for b in bound.values())
    # any table gradient within tol moves each parameter within its bound
    from pathtrace_tpu_torch.render import diff as D

    def chain(d_tables):
        params = D.requires_grad(D.split_params(scene))
        sc = D.merge_params(scene, params)
        packed = list(K.pack_scene(sc, "cpu")) + [K.pack_lights(sc, "cpu")[0]]
        torch.autograd.backward(packed, d_tables)
        return dict(D.named_leaves(D.grads(params)))

    for seed in range(3):
        g = torch.Generator().manual_seed(10 + seed)
        d = [t * (2 * torch.rand(t.shape, generator=g) - 1) for t in tol]
        moved = chain(d)
        for name, b in bound.items():
            assert bool((moved[name].abs() <= b * (1 + 1e-5) + 1e-6).all()), name
    # and a zero bound on the tables gives zero
    zero = dict(GC.chain_bound(scene, True, [0 * t for t in tol]))
    assert all(not bool(b.any()) for b in zero.values())
