"""K8's sections on a BVH mesh: the port's plain version against the
reference.

``render_vjp(..., device="cpu")`` against ``jax.vjp`` of the reference's
planes engine with ``bvh_grad=True`` (``tests/torch_vjp_ref.py``) on
cornell_mesh.txt cut to the light, the floor, the back wall and the
icosahedron: with the ``MESH_GLASS`` and ``MESH_MOTION`` variants (the
icosahedron glass, checkered and moving) with NEE (16x16 depth 4) and
without (48x48 depth 4), every parameter group but ``tri_verts`` (None,
as the reference's ``render_vjp_pallas`` gives) to rtol 2e-4 / atol
3e-4, the reference's own tolerance; the checker's color is not zero in
the reference's gradient, and with NEE the ior and the moving mesh's
translation are not either.  With ``MESH_BUMP`` (the icosahedron bumped)
and NEE (16x16 depth 2), the bump's scale and strength are not zero, and
the groups hold to the reference's tolerance too (the primitive bump's
rounding, ``tests/test_torch_vjp_bump.py``, stays small on the
icosahedron's unit-scaled rows; ``tests/torch_reading64.py mesh-bump``
reads this rig in float64).
"""

import numpy as np
import pytest
import torch

from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.scene.variants import MESH_BUMP, MESH_GLASS, MESH_MOTION

from torch_vjp_ref import assert_matches, reference_case, rig

KEEP = (0, 1, 3, 6)  # light, floor, back wall, icosahedron
MESH_MAT, MESH_GEOM = 4, 3
RIGS = {
    "gcm-bsdf": lambda: rig("cornell_mesh", (MESH_GLASS, MESH_MOTION),
                            keep=KEEP, res=(48, 48)),
    "gcm-nee": lambda: rig("cornell_mesh", (MESH_GLASS, MESH_MOTION),
                           keep=KEEP),
    "bump-nee": lambda: rig("cornell_mesh", (MESH_BUMP,), keep=KEEP, depth=2),
}
# case: (its leaves, nee, mask)
CASES = {"gcm-bsdf": ("gcm", False, 537), "gcm-nee": ("gcm", True, 665),
         "bump-nee": ("bump", True, 672)}


@pytest.fixture(scope="module", params=sorted(CASES))
def mesh_case(request):
    """(rig name, nee, port scene, ct, the reference's gradients)."""
    name, nee, mask = CASES[request.param]
    js, scene = RIGS[request.param]()
    assert scene.mesh.bvh_meta and K.scene_mask(scene, nee) == mask
    return (name, nee, scene) + reference_case(js, scene, nee)


def test_mesh_sections_match_reference(mesh_case):
    name, nee, scene, ct, want = mesh_case
    own = {"gcm": ("materials.ior", "materials.checker_color"),
           "bump": ("materials.bump_scale", "materials.bump_strength")}[name]
    for leaf in own if nee else ("materials.checker_color",):
        assert np.abs(want[leaf][MESH_MAT]).max() > 0, leaf
    if nee and name == "gcm":
        assert np.abs(want["translation"][MESH_GEOM]).max() > 0
    assert_matches(scene, nee, ct, want)


def test_mesh_sections_give_the_plain_radiance(mesh_case):
    _, nee, scene, ct, _ = mesh_case
    rad, _ = VJ.render_vjp(scene, ct, 1, 1, nee=nee, device="cpu")
    want, _ = K.trace_plain(**K.prepare(scene, "cpu", nee=nee), it0=1,
                            n_spp=1)
    assert torch.equal(rad, want)
