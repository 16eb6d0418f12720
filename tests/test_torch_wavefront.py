"""The wavefront integrator (``render/integrator.py``) against the
reference's, 32x32 depth 4, 2 samples: cornell, sphere, cornell_glass and
cornell_mesh, each with and without NEE, against the reference's jitted
wavefront, its numpy oracle and the port's ``trace_plain``
(``tests/torch_wavefront_ref.py`` gives the bounds), and
``compaction="sort"`` bit-equal to ``"mask"``; then the wavefront's own
properties: the densify permutation, a subset of pixels, the iteration
and render entry points."""

import numpy as np
import pytest
import torch

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops import scan as SC
from pathtrace_tpu_torch.render import integrator as I

import torch_wavefront_ref as W
from torch_scenes import load

NAMES = ["cornell", "cornell-nee", "sphere", "sphere-nee", "cornell_glass",
         "cornell_glass-nee", "cornell_mesh", "cornell_mesh-nee"]


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_matches_reference_wavefront(name):
    W.check(name, "reference")


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_matches_reference_oracle(name):
    W.check(name, "oracle")


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_within_tie_bound_of_trace_plain(name):
    W.check(name, "plain")


@pytest.mark.parametrize("name", NAMES)
def test_sort_is_mask_bit_for_bit(name):
    W.check_sort(name)


def test_densify_permutation_is_a_stable_argsort_of_the_dead_flag():
    rs = np.random.default_rng(21)
    n = 9000  # three of the plain scan's tiles
    live = torch.as_tensor(rs.uniform(size=n) < 0.37)
    state = dict(live=live, pixel=torch.arange(n),
                 origins=torch.as_tensor(rs.normal(size=(n, 3))))
    dense = I._densify(state)
    perm = torch.argsort(~live, stable=True)
    assert torch.equal(dense["pixel"], perm)
    assert torch.equal(dense["origins"], state["origins"][perm])
    assert torch.equal(dense["live"], live[perm])
    # on the CPU the scan is K6's plain version: no launch
    assert SC.LAUNCHES["k6_scan"] == 0


def test_a_subset_of_pixels_gives_the_image_rows():
    # every draw is keyed on the global pixel id
    scene = I.resident(load("cornell_glass", res=(12, 10), depth=4), "cpu")
    whole, _ = I.trace_pixels(scene, 3, torch.arange(120), "sort", nee=True)
    rows = torch.tensor([117, 5, 64, 0, 33, 90])
    part, counts = I.trace_pixels(scene, 3, rows, "sort", nee=True)
    assert torch.equal(part, whole[rows])
    assert counts[0] == len(rows)


def test_iteration_batch_and_render_agree():
    scene = load("cornell", res=(10, 8), depth=3)
    rad, counts = I.pathtrace_batch(scene, 4, 3, device="cpu")
    assert rad.shape == (80, 3) and counts.shape == (3, 3)
    assert counts.dtype == torch.int64
    acc = torch.zeros_like(rad)
    for i, it in enumerate(range(4, 7)):
        r, c = ptt.pathtrace_iteration(scene, it, device="cpu")
        acc = acc + r
        assert torch.equal(c, counts[i])
    assert torch.equal(acc, rad)
    seen = []
    img = I.render(scene, 5, chunk=2, device="cpu",
                   callback=lambda done, a, c: seen.append((done, c.shape)))
    assert seen == [(2, (2, 3)), (4, (2, 3)), (5, (1, 3))]
    want = sum((I.pathtrace_batch(scene, i0, n, device="cpu")[0]
                for i0, n in ((1, 2), (3, 2), (5, 1))), torch.zeros_like(rad))
    assert torch.equal(img, want)


def test_remat_changes_no_forward_bit():
    scene = load("cornell_mesh", res=(8, 8), depth=3)
    a = I.pathtrace_batch(scene, 1, 1, remat=True, nee=True, device="cpu")
    b = I.pathtrace_batch(scene, 1, 1, remat=False, nee=True, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wavefront_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = load("cornell", res=(4, 4), depth=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        I.pathtrace_batch(scene, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.pathtrace_iteration(scene, 1)


def test_bad_compaction_raises():
    scene = I.resident(load("cornell", res=(4, 4), depth=2), "cpu")
    with pytest.raises(ValueError, match="compaction"):
        I.trace_pixels(scene, 1, torch.arange(16), "dense")


def test_resident_moves_arrays_once():
    scene = load("cornell_tex", res=(4, 4), depth=2)
    res = I.resident(scene, "cpu")
    assert isinstance(res.materials.color, torch.Tensor)
    assert isinstance(res.textures[0], torch.Tensor)
    assert isinstance(res.geoms.material_id, np.ndarray)
    again = I.resident(res, "cpu")
    assert again.materials.color is res.materials.color
    assert again.textures[0] is res.textures[0]
