"""The check of ``correct`` can fail, at a tiny size on the CPU: the
control (the reference in bfloat16 in the program's place) fails every
cell's limits, and a run with the timed path broken underneath comes out
not correct, for each fault the cell can have: a step that leaves its
state unchanged, half the samples rendered and doubled, an answer
altered where it is made, and on several ranks the exchange left out.
A sound run comes out correct.  ``benchmark/control.py`` runs the
control on the card at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness.cells import Cells
from benchmark.tests import tiny

ONE_CHIP = ("cornell.render", "cornell_bigmesh.render",
            "cornell.inverse_light")
CELLS = ONE_CHIP + ("cornell_bigmesh.render.shard4",)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    cells = Cells(root)
    limits = cells.limits(cell)
    nums = control.control_numbers(cells, cell, 3000000005,
                                   torch.device("cpu"))
    assert any(v > limits[k]["limit"] for k, v in nums.items()), nums


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(root, cell):
    assert tiny.measure(root, cell)["correct"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_broken_run_is_not_correct(root, cell, fault):
    res = tiny.measure(root, cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_sharded_run(root, fault):
    res = tiny.measure(root, "cornell_bigmesh.render.shard4", fault=fault)
    assert res["correct"] == (fault is None), res["checks"]
