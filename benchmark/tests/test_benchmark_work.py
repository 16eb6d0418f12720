"""The frozen work counts: the reference's count of a tiny scene equals
the port's ``ops/cuda/bound.py`` count of its plain version on this
tree (operations by section, bytes by table, the lanes of K8's
sections), and ``k8_extra`` and ``bound`` are the port's, on the
benchmark's configurations and on two with glass, an imperfect specular
sphere and a thin lens (``tiny.glass_config``), whose sections tally.  The frozen
files hold every key the roofline readers read."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import scenes
from benchmark.reference import bound as RB
from benchmark.reference import tables as RT
from benchmark.tests import tiny
from benchmark.work import recount

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import bound as PB
from pathtrace_tpu_torch.ops.cuda import megakernel as K


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", ["cornell", "cornell_bigmesh",
                                  "cornell_glass", "cornell_bigmesh_glass"])
def test_count_is_the_ports(tmp_path, name, nee):
    root = tiny.make_root(tmp_path, res=(20, 12), depth=4)
    base = name.removesuffix("_glass")
    cfg = json.loads((root / "benchmark" / "configs" /
                      f"{base}.json").read_text())
    if name != base:
        cfg = tiny.glass_config(cfg)
    path, objs = scenes.write_scene(cfg, tmp_path / "scene")
    job = K.prepare(ptt.load_scene(path), "cpu", nee=nee)
    want_t = {}
    (_, want_c), want_ops, want_bytes = PB.count_work(
        lambda: K.trace_plain(**job, it0=recount.IT0, n_spp=1), want_t)
    tab = RT.pack(RT.scene_from_config(cfg, objs), nee=nee)
    ops, n_bytes, ops_by, bytes_by, tallies, counts = recount.count(
        tab, 20 * 12)
    assert ops_by == want_ops
    assert bytes_by == want_bytes
    assert tallies == want_t
    assert set(tallies) == ({"dof", "imperfect", "refraction"}
                            if name != base else set())
    assert all(tallies.values())
    assert counts == want_c.tolist()
    small = sum(job[k].numel() * 4 for k in ("cam", "mats", "gmat", "lights")
                if job[k] is not None) + 4 * (
        len(job["geom_types"]) * 7 + 5 * len(job["bvh_meta"]))
    assert n_bytes == small + sum(want_bytes.values()) + 12 * 20 * 12
    n_tab = sum(job[k].numel() for k in ("cam", "mats", "gmat", "lights")
                if job[k] is not None)
    assert RB.k8_extra(counts, 240, n_tab, nee, tallies=tallies) == \
        PB.k8_extra(counts, 240, n_tab, nee, tallies=tallies)
    assert RB.bound(ops, n_bytes) == PB.bound(ops, n_bytes)


@pytest.mark.parametrize("name", ["cornell", "cornell_bigmesh"])
def test_frozen_files(name):
    work = json.loads((tiny.REPO / "benchmark" / "work" /
                       f"{name}.json").read_text())
    assert work["config"] == name
    for key in ("k1", "k1.nee", "k8.nee"):
        assert work[key]["ops"] > 0 and work[key]["bytes"] > 0
    cfg = json.loads((tiny.REPO / "benchmark" / "configs" /
                      f"{name}.json").read_text())
    assert [work["width"], work["height"]] == cfg["camera"]["res"]
    assert work["depth"] == cfg["camera"]["depth"]
    assert work["peaks"] == dict(flops=PB.PEAK_FLOPS,
                                 bytes_per_s=PB.PEAK_BYTES)
