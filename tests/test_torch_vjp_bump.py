"""K8's bump section: the port's plain version against the reference.

``render_vjp(..., device="cpu")`` against ``jax.vjp`` of the reference's
planes engine (``tests/torch_vjp_ref.py``) on cornell_glass.txt with the
``BUMP`` variant (the diffuse white of the floor and the back wall
bumped), cut to the light, the floor, the back and left walls and the
glass sphere, at 16x16 depth 2 (NEE at the first hit reaches the bump).
Without NEE every parameter group holds to rtol 2e-4 / atol 3e-4, the
reference's own tolerance, and the bump's leaves are zero in both (the
radiance is a product of tints at fixed draws).  With NEE the bump's
scale and strength are not zero, and the groups hold to ``NEE_TOL``: the
two forwards agree bit for bit on 81% of the pixels, because XLA's CPU
build contracts multiply-adds into FMAs where the port rounds each
product, and the tilted normal magnifies that (the floor's
inverse-transpose row of 100 against the bump's tangent of about 1).
``tests/torch_reading64.py bump`` reads this rig in float64, where the
reference and the port agree to 3e-10 of the largest camera gradient
while each float32 reading lies 6e-4 to 2e-3 from its float64 one: the
gap is rounding.  The largest gap measured here, |g - w| / (1 + |w|),
was 1.8e-3 (the scale); ``NEE_TOL`` allows about three times that
(CHANGES.md).
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.scene.variants import BUMP

from torch_vjp_ref import assert_matches, reference_case, rig

WHITE = 1  # the bumped material
NEE_TOL = (5e-3, 5e-3)  # rtol, atol
RIGS = {"bump": lambda: rig("cornell_glass", (BUMP,), keep=(0, 1, 3, 4, 6),
                            depth=2)}


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def bump_case(request):
    """(nee, port scene, ct, the reference's gradients)."""
    nee = request.param
    js, scene = RIGS["bump"]()
    assert K.scene_mask(scene, nee) == 39 | (K.NEE_BIT if nee else 0)
    return (nee, scene) + reference_case(js, scene, nee)


def test_bump_matches_reference(bump_case):
    nee, scene, ct, want = bump_case
    for name in ("materials.bump_scale", "materials.bump_strength"):
        if nee:
            assert np.abs(want[name][WHITE]) > 0, name
        else:
            assert not np.abs(want[name]).any(), name
    assert_matches(scene, nee, ct, want, *(NEE_TOL if nee else ()))


def test_bump_gives_the_plain_radiance(bump_case):
    nee, scene, ct, _ = bump_case
    rad, _ = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
