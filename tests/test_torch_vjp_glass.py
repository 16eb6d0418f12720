"""K8's glass, imperfect-specular and depth-of-field sections: the port's
plain version against the reference.

``render_vjp(..., device="cpu")`` (autograd over the plain trace with the
scene's sections on) against ``jax.vjp`` of the reference's planes engine
(``tests/torch_vjp_ref.py``) on cornell_glass.txt (a glass sphere, an
imperfect-specular sphere, a thin-lens camera) at 16x16, every parameter
group to rtol 2e-4 / atol 3e-4, the reference's own tolerance.  With NEE
(depth 4) each section's own leaf is not zero in the reference's
gradient: the aperture and the focal distance (the thin lens), the
specular exponent (the power-cosine lobe) and the ior (Snell's
direction).  Without NEE the radiance is a product of tints at fixed
draws, so only the materials' tints move: at 48x48 depth 5 the glass
sphere's color (its refraction tint) and the imperfect sphere's specular
color are not zero.
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

from torch_vjp_ref import assert_matches, reference_case, rig

GLASS, IMPERFECT = 4, 5  # the spheres' materials
OWN = ("camera.aperture", "camera.focal_dist", "materials.spec_exponent",
       "materials.ior")


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def glass_case(request):
    """(nee, port scene, ct, the reference's gradients)."""
    nee = request.param
    js, scene = (rig("cornell_glass") if nee else
                 rig("cornell_glass", res=(48, 48), depth=5))
    assert K.scene_mask(scene, nee) == 7 | (K.NEE_BIT if nee else 0)
    return (nee, scene) + reference_case(js, scene, nee)


def test_glass_sections_match_reference(glass_case):
    nee, scene, ct, want = glass_case
    if nee:
        for name in OWN:
            assert np.abs(want[name]).max() > 0, name
    else:
        assert np.abs(want["materials.color"][GLASS]).max() > 0
        assert np.abs(want["materials.spec_color"][IMPERFECT]).max() > 0
    assert_matches(scene, nee, ct, want)


def test_glass_sections_give_the_plain_radiance(glass_case):
    nee, scene, ct, _ = glass_case
    rad, _ = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
