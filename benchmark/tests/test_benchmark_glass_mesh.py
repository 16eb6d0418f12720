"""The configuration ``cornell_bigmesh_glass`` and its two cells: the
committed configuration is ``tiny.glass_config`` of ``cornell_bigmesh``
in every scene key (the scene the reference was held to bit for bit);
its frozen work file holds what the roofline reads, and (marked
``cuda``, on a card only) recounts to the same numbers; a tiny run of
each cell on the CPU is ``correct``, and its traced run, as
``cornell_bigmesh.render``'s, reads ``k1_nodes_per_walk`` from the
program's ``k1`` counter."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.reference import bound as RB
from benchmark.tests import tiny

BENCH = tiny.REPO / "benchmark"
NAME = "cornell_bigmesh_glass"
CELLS = (f"{NAME}.render", f"{NAME}.render_nee")
SCENE_KEYS = ("name", "camera", "materials", "objects")


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_config_is_the_glass_config_of_cornell_bigmesh():
    cfg = _config(NAME)
    want = tiny.glass_config(_config("cornell_bigmesh"))
    assert set(cfg) == set(SCENE_KEYS) | {"source", "taken_from", "reduced",
                                          "assumed", "precision"}
    for key in SCENE_KEYS:
        assert cfg[key] == want[key], key
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entry = [c for c in spec["configs"] if c["name"] == NAME]
    assert len(entry) == 1 and entry[0]["source"] == cfg["source"]
    assert {c["name"] for c in spec["workloads"]
            if c["config"] == NAME} == set(CELLS)


def test_frozen_work_file():
    work = json.loads((BENCH / "work" / f"{NAME}.json").read_text())
    cam = _config(NAME)["camera"]
    assert work["config"] == NAME and work["iteration"] == 1
    assert [work["width"], work["height"]] == cam["res"]
    assert work["depth"] == cam["depth"]
    assert work["peaks"] == dict(flops=RB.PEAK_FLOPS,
                                 bytes_per_s=RB.PEAK_BYTES)
    for key in ("k1", "k1.nee"):
        w = work[key]
        assert w["ops"] == pytest.approx(sum(w["ops_by_section"].values()))
        assert [w["bound_ms"], w["bound_by"]] == list(
            RB.bound(w["ops"], w["bytes"]))
        assert len(w["live_counts"]) == cam["depth"]
        assert w["live_counts"][0] == cam["res"][0] * cam["res"][1]
    assert work["k8.nee"]["ops"] > 0


@pytest.mark.cuda
def test_frozen_work_file_recounts_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a full-size count")
    from benchmark.work import recount

    work = json.loads((BENCH / "work" / f"{NAME}.json").read_text())
    again = recount.recount(_config(NAME), tmp_path / "scene",
                            torch.device("cuda"))
    assert json.loads(json.dumps(again)) == work


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("glass_mesh"))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(root, cell):
    res = tiny.measure(root, cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"ms_per_spp", "setup_s"}


@pytest.mark.parametrize("cell", CELLS + ("cornell_bigmesh.render",))
def test_traced_tiny_run_reads_the_walks(root, cell):
    res = tiny.measure(root, cell, trace=1)
    assert res["correct"], res["checks"]
    nodes = res["metrics"]["k1_nodes_per_walk"]
    assert nodes["unit"] == "nodes" and nodes["value"] >= 1.0
