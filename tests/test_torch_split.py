"""The split engine (``ops/cuda/span.py``) on the CPU: the port's plain
engine bit-equal to ``trace_plain`` (K1's plain version) in every
configuration, and held against the reference's
``pathtrace_batch_split`` in interpret mode within the tie-flip bound.
On the card, K5 and K6 against K1: ``tests/test_torch_cuda.py``."""

import dataclasses

import pytest
import torch

from pathtrace_tpu.ops.pallas.megakernel import pathtrace_batch_split
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops import scan as SC
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import span as SP
import torch_engine_ref as E


@pytest.mark.parametrize("label", sorted(E.CONFIGS))
def test_split_bit_equal_to_trace_plain(label):
    scene, nee, rr = E.load(label)
    split = 1 if label == "sphere" else 2
    got = ptt.pathtrace_batch_split(scene, 1, 2, split=split, device="cpu",
                                    nee=nee, rr=rr)
    E.assert_bit_equal(got, E.plain_reference(scene, nee, rr))


def test_sphere_split_one_leaves_an_empty_table(monkeypatch):
    # every tile dies at bounce 0: the resumed span has no tile to run
    seen = []
    compact = SC.compact_indices

    def spy(mask, plain=False):
        out = compact(mask, plain)
        seen.append(int(out[1]))
        return out

    monkeypatch.setattr(SC, "compact_indices", spy)
    scene, _, _ = E.load("sphere")
    got = ptt.pathtrace_batch_split(scene, 1, 2, split=1, device="cpu")
    assert seen == [0, 0]
    assert got[1].tolist()[1:] == [0] * 4
    E.assert_bit_equal(got, E.plain_reference(scene, False, False))


@pytest.mark.parametrize("split,depth", [(5, 5), (9, 5), (0, 5), (2, 1)])
def test_split_clamp(split, depth):
    # split is held to [1, depth - 1]; depth 1 renders on K1's path
    scene, _, _ = E.load("cornell")
    scene = dataclasses.replace(scene, trace_depth=depth)
    got = ptt.pathtrace_batch_split(scene, 1, 2, split=split, device="cpu")
    E.assert_bit_equal(got, E.plain_reference(scene, False, False))


@pytest.mark.parametrize("name,res,depth,nee", [
    ("cornell", (32, 32), 5, False), ("cornell", (32, 32), 5, True),
    ("sphere", (32, 32), 5, False), ("cornell_mesh", (16, 16), 3, False)])
def test_split_matches_reference(name, res, depth, nee):
    E.against_reference(pathtrace_batch_split, ptt.pathtrace_batch_split,
                        name, res, depth, nee, split=2)


def test_split_tile_table_is_the_reference_order():
    # the live-tile table: the stable live-first order of the tiles, the
    # reference's argsort(~tlive, stable), from the scan
    scene, _, _ = E.load("ragged")
    job = K.prepare(scene, "cpu")
    keys = K.state_keys(job["features"], False)
    state = torch.empty((len(keys), 20 * 27))
    SP.trace_span(job, state, keys, 0, 2, 1,
                  torch.zeros(5, dtype=torch.int64))
    live = state[SP.LIVE_KEY] != 0
    tlive = torch.nn.functional.pad(live, (0, 5 * 128 - 540)).view(5, 128)
    tlive = tlive.any(1)
    tbl, n_live = SC.compact_indices(tlive)
    assert tbl.tolist() == torch.argsort(~tlive, stable=True).tolist()
    assert int(n_live) == int(tlive.sum())


@pytest.mark.parametrize("split,sort,depth,name", [
    (None, False, 5, "pallas (K1)"), (0, False, 5, "split at 1 (K5, K6)"),
    (9, False, 5, "split at 4 (K5, K6)"), (3, False, 1, "pallas (K1)"),
    (None, True, 5, "sorted (K5)")])
def test_engine_picks_the_route(split, sort, depth, name):
    # the one choice of the CLI and the entry points: a split (clamped;
    # depth 1 on K1), the sorted engine or K1; every route gives K1's image
    scene, _, _ = E.load("cornell")
    scene = dataclasses.replace(scene, trace_depth=depth)
    job = K.prepare(scene, "cpu")
    got_name, run = SP.engine(scene, job, split, sort)
    assert got_name == name
    E.assert_bit_equal(run(1, 2), E.plain_reference(scene, False, False))


def test_split_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _, _ = E.load("cornell")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ptt.pathtrace_batch_split(scene, 1, 1)
