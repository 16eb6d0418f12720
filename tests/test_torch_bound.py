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
    tri, nodes, meta = K.pack_mesh(scene)
    (n, steps, leaves, _), ops, n_bytes = B.count_work(
        lambda: P.probe_plain(nodes, tri, meta[0], 2, 16))
    assert (n, steps, leaves) == P.probe_plain(nodes, tri, meta[0], 2, 16)[:3]
    # the walk's cursor only moves forward: each step a new node
    assert n_bytes["k9 nodes"] == 9 * 4 * steps
    assert 0 < n_bytes["k9 tri"] <= 4 * meta[0][4]
    assert ops["other"] > 0
