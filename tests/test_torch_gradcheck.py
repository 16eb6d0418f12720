"""The full-size gradient hold of ``tests/torch_gradcheck.py``: the term
magnitudes of a backward pass (``AbsTerms``), the float64 reading, the
same-path mask and the per-entry bound.  No JAX."""

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
    # an entry's term magnitude is at least the sum over pixels of each
    # pixel's part of the gradient (and at least the gradient)
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
    w64, mags = grads(ct)
    rad32, w32 = VJ.k8_plain(*tables[:3], job["geom_types"], job["width"],
                             job["height"], job["depth"], 1, 1, tables[3],
                             ct, job["tri"], job["nodes"], job["bvh_meta"])
    assert bool(GC.same_paths(rad32, rad64).all())
    parts = [torch.zeros_like(t, dtype=torch.float64) for t in tables]
    for p in range(n):
        c = torch.zeros_like(ct)
        c[p] = ct[p]
        for acc, g in zip(parts, GC.reading64(trace, tables)[1](c)[0]):
            acc += g.abs()
    for w, m, part in zip(w64, mags, parts):
        assert w.dtype == m.dtype == torch.float64
        assert bool((m >= w.abs() * (1 - 1e-6)).all())
        assert bool((m >= part * (1 - 1e-6)).all())
    assert float(mags[2].max()) > 10.0 * float(w64[2].abs().max())
    # the float32 plain version within the bound of the float64 reading
    names = ("cam", "mats", "gmat", "lights")
    rows = GC.compare_terms(zip(names, w32), zip(names, w64),
                            zip(names, mags), *GC.K8_TOL)
    assert [r[0] for r in rows] == list(names) and all(r[-1] for r in rows)


def test_compare_terms_holds_each_entry_to_its_own_bound():
    w = torch.tensor([100.0, 1.0, 0.0])
    m = torch.tensor([1e6, 1.0, 0.0], dtype=torch.float64)
    rtol, atol = GC.K8_TOL
    room = atol + rtol * w.double() + GC.EPS32 * m

    def row(g):
        return GC.compare_terms([("t", g)], [("t", w)], [("t", m)], rtol,
                                atol)[0]

    assert row(w + 0.9 * room.float())[-1]
    # the entry of small terms gets no share of the large one's room
    assert not row(w + torch.tensor([0.0, 2.0 * float(room[1]), 0.0]))[-1]
    name, scale, err, ratio, need, ok = row(
        w + torch.tensor([float(room[0]) * 1.5, 0.0, 0.0]))
    assert (name, scale, ok) == ("t", 100.0, False)
    assert ratio == pytest.approx(1.5, rel=1e-4) and need > 1.0
    assert not row(torch.tensor([100.0, float("nan"), 0.0]))[-1]


def test_same_paths_marks_pixels_that_part():
    rad32 = torch.tensor([[1.0, 2.0, 3.0], [10.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    rad64 = rad32.double() + torch.tensor([[1e-6, 0.0, 0.0],
                                           [5e-3, 0.0, 0.0],
                                           [0.0, 0.0, 2e-4]],
                                          dtype=torch.float64)
    assert GC.same_paths(rad32, rad64).tolist() == [True, False, False]
