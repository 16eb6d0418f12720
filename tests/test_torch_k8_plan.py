"""K8's host-side plan (``ops/cuda/vjp.py``): :func:`k8_plan` cuts a call
into chunks of samples and, where one sample of the image passes the
tape's ceiling, ranges of pixels.  A pure function, run on the CPU with
the sizes the builds report (``pt_k8_record_bytes``: 48 bytes a record,
64 with NEE and a mesh or with SSS, 80 with the medium, the visibility
and the triangle row; ``pt_k8_carry_bytes``: 64): every (pixel, sample)
falls in one chunk, each range's samples in order and its chunks one
after another (its carried camera sums are the range's), every chunk's
tape within the budget, and the sizes ``trace_k8`` refuses raise.
Imports neither JAX nor the JAX package.
"""

import pytest

from pathtrace_tpu_torch.ops.cuda import vjp as VJ

CELL, MESH_NEE, LARGEST = 48, 64, 80  # records: cornell NEE's, 640's, the most
CARRY = 64


def _path_bytes(depth, record):
    return depth * record + 1


# (n_pix, n_spp, depth, record, budget, chunks, ranges)
PLANS = {
    "800x800 d8 8 spp, the inverse cell": (
        800 * 800, 8, 8, CELL, VJ.TAPE_BYTES, 1, 1),
    "800x800 d8 8 spp, the mesh with NEE": (
        800 * 800, 8, 8, MESH_NEE, VJ.TAPE_BYTES, 2, 1),
    "800x800 d8 8 spp, the largest record": (
        800 * 800, 8, 8, LARGEST, VJ.TAPE_BYTES, 2, 1),
    "800x800 d32 64 spp": (800 * 800, 64, 32, CELL, VJ.TAPE_BYTES, 32, 1),
    "1080p d8 8 spp, the mesh with NEE": (
        1920 * 1080, 8, 8, MESH_NEE, VJ.TAPE_BYTES, 8, 1),
    "1080p d32 4 spp, records of 48": (
        1920 * 1080, 4, 32, CELL, VJ.TAPE_BYTES, 8, 2),
    "1080p d32 4 spp, records of 64": (
        1920 * 1080, 4, 32, MESH_NEE, VJ.TAPE_BYTES, 12, 3),
    "1080p d32 4 spp, the largest record": (
        1920 * 1080, 4, 32, LARGEST, VJ.TAPE_BYTES, 12, 3),
    "1 pixel 4096 spp": (1, 4096, 8, CELL, VJ.TAPE_BYTES, 1, 1),
    "chunks of samples of even size": (
        100, 10, 4, CELL, 100 * (3 * _path_bytes(4, CELL) + CARRY), 4, 1),
    "one sample a chunk": (
        96 * 80, 5, 8, CELL, 96 * 80 * (_path_bytes(8, CELL) + CARRY), 5, 1),
    "ranges of pixels, a sample a chunk": (
        1000, 3, 8, MESH_NEE, 999 * (_path_bytes(8, MESH_NEE) + CARRY), 6, 2),
    "ranges of even size": (
        1001, 2, 4, CELL, 100 * (_path_bytes(4, CELL) + CARRY), 22, 11),
    "no sample": (4096, 0, 8, CELL, VJ.TAPE_BYTES, 0, 0),
}
BAD = {
    "depth 0": (100, 1, 0, CELL, CARRY, VJ.TAPE_BYTES),
    "depth past the most": (100, 1, VJ.MAX_DEPTH + 1, CELL, CARRY,
                            VJ.TAPE_BYTES),
    "a negative sample count": (100, -1, 8, CELL, CARRY, VJ.TAPE_BYTES),
    "no pixel": (0, 1, 8, CELL, CARRY, VJ.TAPE_BYTES),
    "2^31 pixels": (2 ** 31, 1, 8, CELL, CARRY, VJ.TAPE_BYTES),
    "a record of no bytes": (100, 1, 8, 0, CARRY, VJ.TAPE_BYTES),
    "carried sums of negative bytes": (100, 1, 8, CELL, -4, VJ.TAPE_BYTES),
    "a budget under one path": (100, 1, 8, CELL, CARRY, _path_bytes(8, CELL)),
}


@pytest.mark.parametrize("case", [*PLANS, *(f"bad: {b}" for b in BAD)])
def test_k8_plan(case):
    if case.startswith("bad: "):
        with pytest.raises(ValueError, match="K8"):
            VJ.k8_plan(*BAD[case[5:]])
        return
    n_pix, n_spp, depth, record, budget, n_chunks, n_ranges = PLANS[case]
    plan = VJ.k8_plan(n_pix, n_spp, depth, record, CARRY, budget)
    assert len(plan) == n_chunks, plan[:4]
    ranges = []  # (first pixel, pixels) in plan order, each once
    for px0, n, s0, s1 in plan:
        assert 0 <= px0 and 0 < n and px0 + n <= n_pix, (px0, n)
        assert 0 <= s0 < s1 <= n_spp, (s0, s1)
        tape = n * ((s1 - s0) * _path_bytes(depth, record) + CARRY)
        assert tape <= budget, (px0, n, s0, s1, tape, budget)
        if not ranges or ranges[-1][0] != (px0, n):
            assert (px0, n) not in [r[0] for r in ranges]  # consecutive
            ranges.append(((px0, n), []))
        ranges[-1][1].append((s0, s1))
    assert len(ranges) == n_ranges
    # the ranges cover the image once, and each its samples in order once
    end = 0
    for (px0, n), samples in sorted(ranges):
        assert px0 == end
        end = px0 + n
        assert samples[0][0] == 0 and samples[-1][1] == n_spp
        assert all(a[1] == b[0] for a, b in zip(samples, samples[1:]))
    assert end == (n_pix if plan else 0)
    sizes = [r[0][1] for r in ranges]  # of even size, the last no larger
    assert len(set(sizes[:-1])) <= 1 and (not sizes or sizes[-1] <= sizes[0])
