"""K8's motion-blur and checker sections: the port's plain version against
the reference.

``render_vjp(..., device="cpu")`` against ``jax.vjp`` of the reference's
planes engine (``tests/torch_vjp_ref.py``) on cornell_checker.txt (a
checkered floor, a mirror sphere moving along x) at 16x16 depth 4, every
parameter group to rtol 2e-4 / atol 3e-4, the reference's own tolerance.
The checker's odd cells take their albedo from ``checker_color``, which
is not zero in the reference's gradient with NEE and without; with NEE
the moving sphere's hits and shadow rays, taken at ``origin - time *
velocity``, give its translation a gradient (without NEE every geometry
gradient is zero: the radiance is a product of tints at fixed draws).
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

from torch_vjp_ref import assert_matches, reference_case, rig

FLOOR = 1   # the checkered material
MOVING = 6  # the moving sphere's geom


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def checker_case(request):
    """(nee, port scene, ct, the reference's gradients)."""
    nee = request.param
    js, scene = rig("cornell_checker")
    assert K.scene_mask(scene, nee) == 24 | (K.NEE_BIT if nee else 0)
    return (nee, scene) + reference_case(js, scene, nee)


def test_motion_and_checker_match_reference(checker_case):
    nee, scene, ct, want = checker_case
    assert np.abs(want["materials.checker_color"][FLOOR]).max() > 0
    if nee:
        assert np.abs(want["translation"][MOVING]).max() > 0
    assert_matches(scene, nee, ct, want)


def test_motion_and_checker_give_the_plain_radiance(checker_case):
    nee, scene, ct, _ = checker_case
    rad, _ = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
