"""The lane-schedule model of K1 (``tests/torch_lane_model.py``) on the
CPU: its lockstep schedule counts what ``trace_plain`` counts per sample,
and its pool schedule, the kernel's, runs each pixel's samples in order on
one lane, each path for as many steps as it has live bounces."""

import numpy as np
import pytest

from pathtrace_tpu_torch.ops.cuda import megakernel as K
import torch_lane_model as M
import torch_scenes as S


def _lengths(name, res, depth, spp):
    job = K.prepare(S.load(name, (), res, depth), "cpu")
    return job, M.path_lengths(job, 3, spp)


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh"])
def test_lockstep_counts_are_trace_plains(name):
    job, lengths = _lengths(name, (16, 12), 5, 3)
    steps, counts = M.lockstep(lengths, 5)
    _, want = K.trace_plain(**job, it0=3, n_spp=3, per_sample=True)
    np.testing.assert_array_equal(counts, want.numpy())
    # a warp of neighbouring pixels waits for its longest path each sample
    assert steps == sum(int(w.max()) for s in lengths
                        for w in s.reshape(-1, M.WARP))


@pytest.mark.parametrize("lane_px", [1, 2, 3])
def test_pool_runs_each_pixels_samples_in_order(lane_px):
    job, lengths = _lengths("cornell", (24, 20), 5, 3)
    steps, lanes = M.pool(lengths, lane_px, trace=True)
    seen = {}
    counts = np.zeros((3, 5), np.int64)
    for (block, lane), run in lanes.items():
        for pixel, sample, d in run:
            seen.setdefault(pixel, []).append((block, lane, sample, d))
            counts[sample, d] += 1
    assert sorted(seen) == list(range(24 * 20))
    for pixel, run in seen.items():
        # one lane, its samples in order, each path's bounces from 0
        assert len({(b, ln) for b, ln, _, _ in run}) == 1
        assert [(s, d) for _, _, s, d in run] == [
            (s, d) for s in range(3) for d in range(lengths[s, pixel])]
    _, want = K.trace_plain(**job, it0=3, n_spp=3, per_sample=True)
    np.testing.assert_array_equal(counts, want.numpy())
    # fewer warp steps than the lockstep loop; one pixel a lane at one
    # sample a pixel is the lockstep loop
    assert steps < M.lockstep(lengths, 5)[0]
    assert M.pool(lengths[:1], 1) == M.lockstep(lengths[:1], 5)[0]
