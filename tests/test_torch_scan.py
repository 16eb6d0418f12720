"""The port's scan (``pathtrace_tpu_torch/ops/scan.py``: K6's plain
version on the CPU) against the reference's ``prefix_sum_pallas``,
``compact_indices`` and ``compact`` in interpret mode: exactly equal, on
the reference test's cases (``tests/test_scan.py``), inputs from a numpy
seed.  K6 itself runs on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu.ops.scan import compact as ref_compact
from pathtrace_tpu.ops.scan import compact_indices as ref_compact_indices
from pathtrace_tpu.ops.scan import prefix_sum_pallas
import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops import scan as SC


@pytest.mark.parametrize("n", [1, 100, 1024, 1025, 4096, 10000])
def test_prefix_sum_matches_reference(n):
    r = np.random.RandomState(n)
    x = (r.rand(n) < 0.4).astype(np.float32)
    want = np.asarray(prefix_sum_pallas(jnp.asarray(x), interpret=True))
    got = ptt.prefix_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.cumsum(x) - x)


def test_prefix_sum_integers_match_reference():
    r = np.random.RandomState(7)
    x = r.randint(0, 1000, size=3000).astype(np.int32)
    want = np.asarray(prefix_sum_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        ptt.prefix_sum(torch.from_numpy(x)).numpy(), want)


def test_compact_matches_reference():
    r = np.random.RandomState(3)
    n = 5000
    mask = r.rand(n) < 0.3
    payload = {"a": r.rand(n, 3).astype(np.float32),
               "b": np.arange(n, dtype=np.int32)}
    want, want_live = ref_compact(jnp.asarray(mask), payload, interpret=True)
    got, n_live = ptt.compact(
        torch.from_numpy(mask), {k: torch.from_numpy(v)
                                 for k, v in payload.items()})
    assert n_live.dtype == torch.int32 and n_live.dim() == 0
    assert int(n_live) == int(want_live) == mask.sum()
    for k in payload:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_compact_indices_matches_reference_and_argsort():
    r = np.random.RandomState(11)
    mask = r.rand(4096) < 0.5
    want, want_live = ref_compact_indices(jnp.asarray(mask), interpret=True)
    perm, n_live = ptt.compact_indices(torch.from_numpy(mask))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(~mask, kind="stable"))
    assert int(n_live) == int(want_live)


@pytest.mark.parametrize("n", [SC.TILE, SC.TILE + 1, SC.TILE ** 2 + 5])
def test_plain_scan_over_several_levels(n):
    # one tile, two, and three levels of tile totals
    x = torch.from_numpy(np.random.RandomState(n).randint(
        0, 3, size=n).astype(np.int32))
    want = torch.cumsum(x.long(), 0) - x
    assert torch.equal(SC.prefix_sum_plain(x), want.int())


@pytest.mark.parametrize("mask", [[True] * 5, [False] * 5, [True]])
def test_compact_indices_all_live_all_dead(mask):
    perm, n_live = ptt.compact_indices(torch.tensor(mask))
    assert perm.tolist() == list(range(len(mask)))
    assert int(n_live) == sum(mask)


def test_scan_rejects_bad_input():
    with pytest.raises(ValueError, match="1-D"):
        ptt.prefix_sum(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="1-D"):
        ptt.prefix_sum(torch.zeros(0))
