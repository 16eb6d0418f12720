"""K1's event counters (``megakernel.K1_EVENTS``) and the counters of
``utils/profiling``: ``counter`` gives nothing and keeps nothing without a
profiler, gives its tensor to the first call of a window alone, and starts
afresh in a new window; on a small glass-mesh scene
(``cornell_glass``'s materials and lens, its glass sphere replaced by a
level-1 icosphere of glass) the plain version's scatter events of a
bounce are the live paths of the next, its walks are the live paths and
the shadow rays, and the walks of refracted rays are the refractions
before them; ``_mesh_walk`` counts the nodes worked out by hand on a
small BVH; ``trace_k1`` counts the first call of a window alone, on a
scene without glass, imperfect specular or a mesh too.  On a card (marker
``cuda``, skipped without one) K1's counters equal the plain version's
exactly on that scene, with and without NEE, and on the box with a mesh
and without one.

This file imports neither JAX nor the JAX package, so on a card it runs
as ``python -m pytest --noconftest -q tests/test_torch_k1_events.py``.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EV = len(K.K1_EVENTS)
N_SCATTER = len(K.SCATTER_KINDS)
REFRACTED, OTHER, SHADOW = (K.RAY_KINDS.index(k)
                            for k in ("refracted", "other", "shadow"))


def _walks(ev, kind):
    return ev[..., N_SCATTER + 2 * kind]


def _nodes(ev, kind):
    return ev[..., N_SCATTER + 2 * kind + 1]


def glass_mesh_scene(directory, res=(16, 12), depth=5, level=1):
    """``cornell_glass.txt`` with its glass sphere replaced by a level-
    ``level`` icosphere of the same glass, placed as cornell_bigmesh's
    mesh: glass, the SPECEX-64 sphere and the thin lens over a BVH."""
    spec = importlib.util.spec_from_file_location(
        "pt_gen_mesh", os.path.join(REPO, "tools", "gen_mesh.py"))
    gen_mesh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_mesh)
    gen_mesh.write_obj(os.path.join(directory, "ico.obj"),
                       *gen_mesh.gen(level))
    with open(os.path.join(REPO, "scenes", "cornell_glass.txt")) as f:
        text = f.read()
    old = "OBJECT 6\nsphere\nmaterial 4\nTRANS       -1.5 2 1\n" \
          "ROTAT       0 0 0\nSCALE       3 3 3"
    assert text.count(old) == 1
    text = text.replace(old, "OBJECT 6\nmesh ico.obj\nmaterial 4\n"
                        "TRANS 0 3 -1\nROTAT 0 30 0\nSCALE 2 2 2")
    scene = ptt.parse_scene(text, base_dir=str(directory))
    scene = dataclasses.replace(scene, resolution=res, trace_depth=depth)
    assert K.scene_mask(scene) == 519 and K.scene_mask(scene, nee=True) == 647
    return scene


def test_no_profiler_no_counter():
    assert not torch._C._autograd._profiler_enabled()
    before = profiling.counters()
    assert profiling.counter("k1", (4, N_EV), "cpu") is None
    assert profiling.counters().keys() == before.keys()


def test_counter_counts_the_first_call_of_a_window(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        a = profiling.counter("t", (3,), torch.device("cpu"))
        assert a.tolist() == [0, 0, 0]
        a += torch.tensor([1, 2, 3])
        assert profiling.counter("t", (3,), torch.device("cpu")) is None
        assert profiling.counter("t", (4,), torch.device("cpu")) is None
        profiling.counter("u", (2,), torch.device("cpu")).add_(7)
    got = profiling.counters()
    assert set(got) == {"t", "u"} and got["t"].tolist() == [1, 2, 3]
    assert got["u"].tolist() == [7, 7]
    assert profiling.counter("t", (3,), "cpu") is None
    with profiling.trace(str(tmp_path), device="cpu"):
        pass
    assert profiling.counters() == {}


def test_counters_start_afresh_in_a_new_window():
    """A window that a plain ``torch.profiler`` opens, as the benchmark
    does, starts the counters afresh once the program has asked for one
    with no profiler recording, whatever an earlier window left: the name
    counts again, in another shape if asked."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        profiling.counter("k1", (4, N_EV), "cpu").add_(1)
    assert profiling.counters()["k1"].shape == (4, N_EV)
    assert profiling.counter("k1", (3, N_EV), "cpu") is None  # untraced
    assert profiling.counters()["k1"].shape == (4, N_EV)  # still readable
    with profile(activities=[ProfilerActivity.CPU]):
        c = profiling.counter("k1", (3, N_EV), "cpu")
        assert int(c.sum()) == 0
        c[0, 0] += 5
    got = profiling.counters()
    assert set(got) == {"k1"} and got["k1"].sum() == 5


@pytest.mark.parametrize("nee", [False, True])
def test_scatter_events_go_on_as_live_paths(tmp_path, nee):
    """Without RR or SSS every path that scatters enters the next bounce;
    each live path walks the one mesh, each shadow ray of a non-glass
    scattering hit walks it too, and a walk leaves a refraction exactly
    where the bounce before refracted."""
    scene = glass_mesh_scene(tmp_path)
    job = K.prepare(scene, "cpu", nee=nee)
    depth = job["depth"]
    ev = torch.zeros((depth, N_EV), dtype=torch.int64)
    rad, counts = K.trace_plain(**job, it0=5, n_spp=2, events=ev)
    rad0, counts0 = K.trace_plain(**job, it0=5, n_spp=2)
    assert torch.equal(rad, rad0) and torch.equal(counts, counts0)
    scatter = ev[:, :N_SCATTER]
    assert torch.equal(scatter[:-1].sum(1), counts[1:])
    assert torch.equal(_walks(ev, OTHER) + _walks(ev, REFRACTED), counts)
    assert torch.equal(_walks(ev, REFRACTED)[1:],
                       scatter[:-1, K.SCATTER_KINDS.index("refraction")])
    assert int(_walks(ev, REFRACTED)[0]) == 0
    lit = scatter[:, :2].sum(1) * (job["lights"].shape[0] if nee else 0)
    assert torch.equal(_walks(ev, SHADOW), lit)
    for kind in (REFRACTED, OTHER, SHADOW):
        assert bool((_nodes(ev, kind) >= _walks(ev, kind)).all())
    # every kind of event happens on this scene
    assert bool((scatter.sum(0) > 0).all()) and int(_walks(ev, REFRACTED)
                                                     .sum()) > 0
    if nee:
        assert int(_walks(ev, SHADOW).sum()) > 0


def _box(lo, hi, skip, start=0, count=0):
    return list(lo) + list(hi) + [skip, start, count] + [0.0] * 7


def _tri_x(x):
    # the triangle (x, 0, 0), (x, 1, 0), (x, 0, 1): the plane x, y + z <= 1
    return [x, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def test_mesh_walk_counts_the_nodes_worked_out_by_hand():
    """A five-node skip-link BVH over [0,4] x [0,1]^2 (DFS order: root 0;
    node 1 over [0,2] with leaves 2 ([0,1], triangle at x .5) and 3
    ([1,2], at x 1.5); leaf 4 ([3,4], at x 3.5)) and four rays along x:
    A misses the root (node 0 alone); B comes from outside (-x), wins at
    x .5 and prunes nodes 3 and 4 by their boxes (5 nodes: each box is
    tested); C starts inside the root between the leaves and heads -x,
    as a refracted ray starts inside the glass, entering leaf 2, then 3,
    whose nearer triangle wins (5 nodes); D starts inside leaf 4 and
    heads +x: node 1 is skipped, node 4 entered (3 nodes)."""
    nodes = torch.tensor([
        _box((0, 0, 0), (4, 1, 1), 5), _box((0, 0, 0), (2, 1, 1), 4),
        _box((0, 0, 0), (1, 1, 1), 3, 0, 1), _box((1, 0, 0), (2, 1, 1), 4, 1, 1),
        _box((3, 0, 0), (4, 1, 1), 5, 2, 1)], dtype=torch.float32)
    tri = torch.tensor([_tri_x(0.5), _tri_x(1.5), _tri_x(3.5)],
                       dtype=torch.float32)
    o = torch.tensor([[2, 5, .5], [-1, .2, .2], [2.5, .2, .2], [3.2, .2, .2]],
                     dtype=torch.float32)
    d = torch.tensor([[1, 0, 0], [1, 0, 0], [-1, 0, 0], [1, 0, 0]],
                     dtype=torch.float32)
    ray = (*o.unbind(1), *d.unbind(1), *(1.0 / d).unbind(1))
    kind = torch.tensor([OTHER, SHADOW, REFRACTED, REFRACTED])
    row = torch.zeros(N_EV, dtype=torch.int64)
    t0 = torch.full((4,), 1e30)
    want = torch.ones(4, dtype=torch.bool)
    win = K._mesh_walk(ray, t0, want, nodes, tri, 0, (row, kind))
    assert win.tolist() == [-1, 0, 1, 2]
    assert row[:N_SCATTER].tolist() == [0] * N_SCATTER
    assert [int(_walks(row, k)) for k in (REFRACTED, OTHER, SHADOW)] == \
        [2, 1, 1]
    assert [int(_nodes(row, k)) for k in (REFRACTED, OTHER, SHADOW)] == \
        [5 + 3, 1, 5]
    # one ray at a time, a scalar kind: the same nodes each
    for i, n in enumerate((1, 5, 5, 3)):
        one = torch.zeros(N_EV, dtype=torch.int64)
        K._mesh_walk(ray, t0, torch.arange(4) == i, nodes, tri, 0,
                     (one, SHADOW))
        assert int(_walks(one, SHADOW)) == 1 and int(_nodes(one, SHADOW)) == n
    # a ray left out of ``want`` walks nothing
    none = torch.zeros(N_EV, dtype=torch.int64)
    K._mesh_walk(ray, t0, torch.zeros(4, dtype=torch.bool), nodes, tri, 0,
                 (none, kind))
    assert int(none.sum()) == 0


def test_k1_counter_under_a_profiler(tmp_path):
    """``trace_k1`` counts into ``k1`` in the first call of a profiler's
    window alone, on a scene without glass, imperfect specular or a mesh
    too (no walks there); with no profiler nothing is counted, and the
    image and the live counts are the same either way."""
    scene = glass_mesh_scene(tmp_path, res=(8, 6), depth=3)
    job = K.prepare(scene, "cpu")
    want = torch.zeros((3, N_EV), dtype=torch.int64)
    K.trace_plain(**job, it0=1, n_spp=1, events=want)
    plain = K.trace_k1(job, 1, 1)
    with profiling.trace(str(tmp_path), device="cpu"):
        rad, counts = K.trace_k1(job, 1, 1)
        K.trace_k1(job, 9, 1)
    assert torch.equal(rad, plain[0]) and torch.equal(counts, plain[1])
    got = profiling.counters()
    assert set(got) == {"k1"} and np.array_equal(got["k1"], want.numpy())
    cornell = ptt.load_scene(os.path.join(REPO, "scenes", "cornell.txt"))
    cornell = dataclasses.replace(cornell, resolution=(8, 6), trace_depth=3)
    job = K.prepare(cornell, "cpu")
    assert K.scene_mask(cornell) == 0
    with profiling.trace(str(tmp_path), device="cpu"):
        rad, counts = K.trace_k1(job, 1, 2)
    ev = torch.from_numpy(profiling.counters()["k1"])
    assert torch.equal(ev[:-1, :N_SCATTER].sum(1), counts[1:])
    assert int(ev[:, N_SCATTER:].sum()) == 0
    assert torch.equal(rad, K.trace_k1(job, 1, 2)[0])


CARD_SCENES = [("glass_mesh", False), ("glass_mesh", True),
               ("cornell_mesh.txt", False), ("cornell.txt", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, nee", CARD_SCENES)
def test_k1_counters_equal_the_plain_versions_on_the_card(tmp_path, name,
                                                          nee):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    if name == "glass_mesh":
        scene = glass_mesh_scene(tmp_path, res=(64, 48), depth=8, level=2)
    else:
        scene = dataclasses.replace(
            ptt.load_scene(os.path.join(REPO, "scenes", name)),
            resolution=(64, 48), trace_depth=8)
    job = K.prepare(scene, "cuda", nee=nee)
    want = torch.zeros((8, N_EV), dtype=torch.int64, device="cuda")
    rad_p, counts_p = K.trace_plain(**job, it0=3, n_spp=12, events=want)
    rad0, counts0 = K.trace_k1(job, 3, 12)
    with profiling.trace(str(tmp_path), device="cuda"):
        rad, counts = K.trace_k1(job, 3, 12)
        K.trace_k1(job, 15, 12)  # the window's later calls count nothing
    got = profiling.counters()["k1"]
    # counting leaves the image and the live counts as they were
    assert torch.equal(rad, rad0) and torch.equal(counts, counts0)
    assert torch.equal(counts.cpu(), counts_p.cpu())
    assert np.array_equal(got, want.cpu().numpy()), (got, want)
    if nee and name != "cornell.txt":
        assert int(_walks(want, SHADOW).sum()) > 0
    # the per-sample form counts the same
    with profiling.trace(str(tmp_path), device="cuda"):
        K.trace_k1(job, 3, 12, per_sample=True)
    assert np.array_equal(profiling.counters()["k1"], got)
