"""Helpers of the split and sorted engine tests (``test_torch_split.py``,
``test_torch_sorted.py``): the configurations, the port's plain engine
held bit-equal to ``trace_plain``, and held against the reference's
engine in interpret mode within the tie-flip bound."""

import dataclasses
import os

import numpy as np
import torch

import pathtrace_tpu as pt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
import torch_scenes as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# label -> (scene file, variants, nee, rr, resolution, depth): the
# configurations each engine must render bit-equal to trace_plain
CONFIGS = {
    "cornell": ("cornell", (), False, False, (32, 32), 5),
    "sphere": ("sphere", (), False, False, (32, 32), 5),
    "cornell-nee": ("cornell", (), True, False, (32, 32), 5),
    "cornell-rr": ("cornell", (), False, True, (32, 32), 5),
    "glass_bump_sss": ("cornell_glass", (S.BUMP, S.SSS), False, False,
                       (32, 32), 5),
    "mesh_glass_checker_motion": ("cornell_mesh", (S.MESH_GLASS,
                                                   S.MESH_MOTION),
                                  False, False, (16, 16), 3),
    "cornell_tex": ("cornell_tex", (), False, False, (32, 32), 5),
    "ragged": ("cornell", (), False, False, (20, 27), 5),
}


def load(label):
    name, edits, nee, rr, res, depth = CONFIGS[label]
    return S.load(name, edits, res, depth), nee, rr


def assert_bit_equal(got, want):
    assert torch.equal(got[0], want[0]), float((got[0] - want[0]).abs().max())
    assert torch.equal(got[1], want[1]), (got[1].tolist(), want[1].tolist())


def against_reference(ref_engine, port_engine, name, res, depth, nee=False,
                      **kw):
    """The port's plain engine and the reference's (interpret mode) on
    scene file ``name``, 1 spp: under 0.5% of pixels off by more than
    1e-3, bounce 0 counting every pixel, the other bounces within 0.5%.
    Returns the share of bit-equal pixels."""
    path = os.path.join(REPO, "scenes", f"{name}.txt")
    ref_scene = dataclasses.replace(pt.load_scene(path), resolution=res,
                                    trace_depth=depth)
    want, want_counts = ref_engine(ref_scene, 1, 1, interpret=True, nee=nee,
                                   **kw)
    got, counts = port_engine(S.load(name, (), res, depth), 1, 1,
                              device="cpu", nee=nee, **kw)
    d = np.abs(got.numpy() - np.asarray(want)).max(axis=-1)
    share = float((d == 0).mean())
    print(f"{name} {res} d{depth} nee={nee}: bit-equal share {share:.4%}, "
          f"max {d.max():.3g}")
    assert (d > 1e-3).mean() < 0.005
    want_counts = np.asarray(want_counts)
    assert counts[0] == want_counts[0] == res[0] * res[1]
    np.testing.assert_allclose(counts.numpy(), want_counts, rtol=0.005)
    return share


def plain_reference(scene, nee, rr, spp=2):
    """K1's plain version on ``scene``: (radiance, counts)."""
    return K.pathtrace_batch_cuda(scene, 1, spp, "cpu", nee, rr)
