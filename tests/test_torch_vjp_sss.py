"""K8's SSS section: the port's plain version against the reference.

``render_vjp(..., device="cpu")`` against ``jax.vjp`` of the reference's
planes engine (``tests/torch_vjp_ref.py``) on cornell_glass.txt whose
glass sphere holds a thin medium (``SSS_THIN``: sigma 0.5, a mean free
path of about the sphere's radius, so that a path that scatters inside
leaves again within a few bounces; the ``SSS`` variant's sigma 6 keeps
the paths inside past any depth a CPU test can afford), every parameter
group at rtol 2e-4 / atol 3e-4, the reference's own tolerance.  Without
NEE (48x48, depth 5, the box cut to the light, the floor, the back wall
and the sphere) only the tints move, the medium's albedo among them.
With NEE (24x24, depth 4, the box cut to the light, the floor, the back
and left walls and the sphere: few refractions on the paths that scatter
inside, and no imperfect-specular sphere, whose lobe magnifies float32
rounding past the tolerance) the medium's sigma (its free path moves the
scatter point) and albedo (the tint of an inside scatter) are not zero
in the reference's gradient.
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

from torch_vjp_ref import assert_matches, reference_case, rig

SSS_THIN = ("REFRIOR     1.5\nEMITTANCE   0\n",
            "REFRIOR     1.5\nEMITTANCE   0\nSSS         .5 .9 .6 .4\n")
GLASS = 4  # the glass sphere's material, with the medium
RIGS = {
    True: lambda: rig("cornell_glass", (SSS_THIN,), keep=(0, 1, 3, 4, 6),
                      res=(24, 24), depth=4),
    False: lambda: rig("cornell_glass", (SSS_THIN,), keep=(0, 1, 3, 6),
                       res=(48, 48), depth=5),
}


@pytest.fixture(scope="module", params=[False, True], ids=["bsdf", "nee"])
def sss_case(request):
    """(nee, port scene, ct, the reference's gradients)."""
    nee = request.param
    js, scene = RIGS[nee]()
    assert K.scene_mask(scene, nee) == 71 | (K.NEE_BIT if nee else 0)
    return (nee, scene) + reference_case(js, scene, nee)


def test_sss_matches_reference(sss_case):
    nee, scene, ct, want = sss_case
    assert np.abs(want["materials.sss_albedo"][GLASS]).max() > 0
    if nee:
        assert np.abs(want["materials.sss_sigma"][GLASS]) > 0
    assert_matches(scene, nee, ct, want)


def test_sss_gives_the_plain_radiance(sss_case):
    nee, scene, ct, _ = sss_case
    rad, _ = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
