"""The bound's count of the work a kernel needs (``ops/cuda/bound.py``):
its rules on small functions, and its marks in the plain versions, which
leave their results as they are.  No JAX."""

import os

import pytest
import torch

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import bound as B
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import probe as P
import torch_scenes as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bound_is_the_larger_term():
    assert B.bound(67e9, 0) == (pytest.approx(1.0), "operations")
    assert B.bound(67e9, 6.7e9) == (pytest.approx(2.0), "bytes")


def test_span_state_bytes():
    # the split engine, 13 planes, depth 4 split at 2: span A runs 100
    # rays, 30 live at its end write every plane, 70 that ended write
    # radiance and live; span B runs 40 rays of the live tiles: the 30
    # live read every plane, 10 found dead read live, the 30 write their
    # radiance
    counts = [100, 60, 30, 20]
    assert B.span_state_bytes(13, counts, [(0, 2, 100), (2, 4, 40)]) == \
        4 * (13 * 30 + 4 * 70 + 13 * 30 + 10 + 3 * 30)
    # every ray dead after span A: 4 planes each, span B runs no ray
    assert B.span_state_bytes(13, [100, 0, 0, 0],
                              [(0, 2, 100), (2, 4, 0)]) == 4 * 4 * 100
    # the sorted engine, 14 planes with the pixel id: raygen writes it
    # once; later spans read it and never write it
    spans = [(d, d + 1, 100) for d in range(4)]
    assert B.span_state_bytes(14, counts, spans, True) == 4 * (
        100 + 13 * 60 + 4 * 40                          # [0, 1)
        + 14 * 60 + 40 + 13 * 30 + 4 * 30               # [1, 2)
        + 14 * 30 + 70 + 13 * 20 + 4 * 10               # [2, 3)
        + 14 * 20 + 80 + 3 * 20)                        # [3, 4)
    # depth 1: the one span is raygen and the last
    assert B.span_state_bytes(14, [100], [(0, 1, 100)], True) == \
        4 * (100 + 3 * 100)


@pytest.mark.parametrize("n,want", [
    (1, 12), (2048, 8 * 2048 + 4), (2049, 8 * 2049 + 16 * 2 + 4),
    (2048 ** 2 + 1, 8 * (2048 ** 2 + 1) + 16 * 2049 + 16 * 2 + 4)])
def test_scan_bytes(n, want):
    # values read and written once; each level of tile totals written,
    # read, and its offsets written and read; the last total written
    assert B.scan_bytes(n) == want


def test_count_weights_a_section_by_its_lanes():
    x = torch.arange(8, dtype=torch.float32)

    def fn():
        y = x + 1.0                            # 8, every lane
        with B.needed("half", lambda: x < 4.0):  # the mask: not counted
            y = y * 2.0                        # 4 of 8 lanes
            with B.needed(lanes=lambda: x >= 2.0):
                y = y - 1.0                    # lanes 2, 3: 2
            z = torch.where(x > 0.0, y, x)     # a compare (4), no select
        return z

    z, ops, n_bytes = B.count_work(fn)
    assert torch.equal(z, fn())
    assert ops == {"other": 8.0, "half": 4.0 + 2.0 + 4.0}
    assert n_bytes == {}


def test_a_compacted_section_stands_alone():
    x = torch.arange(6, dtype=torch.float32)
    live = torch.tensor([True, False] * 3)

    def fn():
        with B.needed("outer", live):
            with B.needed("walk", compacted=True):
                y = x[live] * 3.0              # 3 compacted lanes, all
                with B.needed(lanes=y > 3.0, compacted=True):
                    y = y + 1.0                # 2 of them
        return y

    _, ops, _ = B.count_work(fn)
    assert ops == {"walk": 3.0 + 3.0 + 2.0}


def test_reads_count_distinct_rows_of_needed_lanes():
    table = torch.zeros(10, 4)
    rows = torch.tensor([1, 1, 2, -1, 7])

    def fn():
        B.read(table, "t", 5, 4)                       # row 5: 16 bytes
        B.read(table, "t", range(5, 7), 4)             # row 6 is new
        with B.needed(lanes=rows != 7):
            B.read(table, "u", rows, 1)                # rows 1, 2
        B.read(table[4:], "t", 0, 4)                   # another slice

    _, _, n_bytes = B.count_work(fn)
    assert n_bytes == {"t": 3 * 16, "u": 2 * 4}


def test_marks_do_nothing_outside_a_count():
    with B.needed("x", lanes=lambda: 1 / 0):
        B.read(None, "t", 0, 1)


@pytest.mark.parametrize("config", [
    "cornell-nee", "sss", "mesh_glass_checker_motion", "cornell_tex-nee",
    "cornell_bumpmesh"])
def test_count_leaves_the_plain_version_as_it_is(config):
    job = S.job(config, (16, 12), 4)
    want = K.trace_plain(**job, it0=1, n_spp=1)
    got, ops, n_bytes = B.count_work(
        lambda: K.trace_plain(**job, it0=1, n_spp=1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops["trace"] > 0 and ops["scatter"] > 0
    if job["lights"] is not None:
        assert ops["nee"] > 0
    if job["tex_geom"] or job["btex_geom"]:
        assert ops["texture"] > 0 and n_bytes["texels"] > 0
    if job["bvh_meta"]:
        assert ops["walk"] > 0 and n_bytes["nodes"] > 0
        assert n_bytes["tri"] <= 9 * 4 * job["tri"].shape[0]


def test_count_of_dead_paths_is_nothing():
    # a path that misses everything at bounce 0 ends: with every camera
    # ray turned away from the box, the bounces after the first need no
    # scattering at all
    job = S.job("cornell", (8, 6), 3)
    cam = job["cam"].clone()
    cam[0, 3:6] = -cam[0, 3:6]  # the view direction reversed
    _, counts = K.trace_plain(**dict(job, cam=cam), it0=1, n_spp=1)
    _, ops, _ = B.count_work(
        lambda: K.trace_plain(**dict(job, cam=cam), it0=1, n_spp=1))
    assert counts.tolist() == [48, 0, 0]
    assert ops.get("scatter", 0.0) == 0.0


def test_k9_reads_each_visited_node_once():
    scene = ptt.load_scene(os.path.join(REPO, "scenes", "cornell_mesh.txt"))
    tri, nodes, meta = K.pack_mesh(scene, "cpu")
    (n, steps, leaves, _), ops, n_bytes = B.count_work(
        lambda: P.probe_plain(nodes, tri, meta[0], 2, 16))
    assert (n, steps, leaves) == P.probe_plain(nodes, tri, meta[0], 2, 16)[:3]
    # the walk's cursor only moves forward: each step a new node
    assert n_bytes["k9 nodes"] == 9 * 4 * steps
    assert 0 < n_bytes["k9 tri"] <= 4 * meta[0][4]
    assert ops["other"] > 0


def test_gradient_kernels_extra_work():
    # 100 pixels, depth 3: 60 paths scatter at bounce 0, 20 at bounce 1
    counts = [100, 60, 20]
    assert B.scatters(counts) == 80
    assert B.k7_extra(counts, 100, 9) == (
        B.K7_PATH_OPS * 100 + B.K7_SCATTER_OPS * 80, 12 * 100 + 64 * 9)
    assert B.k8_extra(counts, 100, 592, nee=True) == (
        B.K8_SCATTER_ADJ_OPS * 80 + B.K8_RAYGEN_ADJ_OPS * 100,
        12 * 100 + 2 * B.K8_SAVED_BYTES * 180 + 4 * 592)
    # without NEE only the materials' gradient is not zero: K7's fold,
    # no stored state
    assert B.k8_extra(counts, 100, 464, nee=False) == (
        B.K7_PATH_OPS * 100 + B.K7_SCATTER_OPS * 80, 12 * 100 + 4 * 464)
    # the mesh builds also keep each bounce's winner
    assert B.k8_extra(counts, 100, 592, nee=True, mesh=True)[1] == (
        12 * 100 + 2 * (B.K8_SAVED_BYTES + B.K8_WINNER_BYTES) * 180
        + 4 * 592)


@pytest.mark.parametrize("nee", [False, True])
def test_linear_fold_counts_every_triangle(nee):
    # K3-linear: every live ray meets every triangle, and every row is read
    from pathtrace_tpu_torch.scene.bvh import without_bvh

    scene = without_bvh(S.load("cornell_mesh", res=(12, 10), depth=3))
    job = K.prepare(scene, "cpu", nee=nee)
    want = K.trace_plain(**job, it0=1, n_spp=1)
    got, ops, n_bytes = B.count_work(
        lambda: K.trace_plain(**job, it0=1, n_spp=1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert "walk" not in ops and "nodes" not in n_bytes
    n_tri = job["tri"].shape[0]
    assert n_bytes["tri"] == 9 * 4 * n_tri
    # the rays traced: the live paths, and with NEE the shadow rays of the
    # diffuse hits, each through every triangle
    rays = int(want[1].sum())
    assert ops["linear"] >= rays * n_tri * 40


def test_linear_fold_charges_the_distance_to_hits_only():
    # K3-linear's ray test (Moller-Trumbore, 52 ops) on every ray and
    # triangle; the world distance (35 ops: the offset point, the
    # transform, the norm, the NaN test) only on the pairs that hit, as
    # the kernel skips a miss
    m = [torch.tensor(float(x)) for x in torch.eye(4)[:3].reshape(-1)]
    tri = torch.zeros(3, 16)
    for r, (v0, z) in enumerate((((-1.0, -1.0), 2.0), ((-1.0, -1.0), 3.0),
                                 ((5.0, 5.0), 2.0))):
        tri[r, :9] = torch.tensor([*v0, z, 2.0, 0.0, 0.0, 0.0, 2.0, 0.0])
    d = torch.tensor([[-0.2, -0.2, 1.0], [0.0, 0.0, -1.0], [2.75, 2.75, 1.0],
                      [0.1, -0.3, 1.0]])
    d = d / d.norm(dim=1, keepdim=True)
    zeros = torch.zeros(4)
    ray = (zeros, zeros, zeros, *d.unbind(1))
    best = torch.full((4,), 1e30)
    want = torch.tensor([True, True, True, False])
    (win, ops, _) = B.count_work(lambda: K._linear_walk(
        m, ray[:3], ray, best, want, tri, 0, 3))
    live = [c[want][:, None] for c in ray]
    _, hit = K._moller_trumbore(live, tri)
    assert int(hit.sum()) == 3     # ray 0 meets rows 0 and 1, ray 2 row 2
    assert win.tolist() == [0, -1, 2, -1]
    assert ops == {"linear": 52.0 * 3 * 3 + 35.0 * 3}
