"""K8's plain version on glass against the reference's kernel in interpret
mode.

``render_vjp_pallas(..., interpret=True)`` (the Pallas ``_vjp_kernel``,
its reverse sweep by ``jax.vjp`` of the tracer) and the port's
``render_vjp(..., device="cpu")`` on the ``GLASS_SCENE`` rig of the
reference's ``tests/test_vjp_kernel.py`` (an emissive backdrop and a glass
sphere, 16x16 depth 3, no NEE), one sample: the radiance within 1e-4 on
every pixel, and the gradients that test holds (the ior, the color and
the specular color) at its tolerance, rtol 1e-3 / atol 1e-3; every group
finite.
"""

import dataclasses

import numpy as np

import pathtrace_tpu as pt
from pathtrace_tpu.ops.pallas.megakernel import render_vjp_pallas
from pathtrace_tpu_torch import convert
from pathtrace_tpu_torch.ops.cuda import vjp as VJ

from test_torch_vjp import grad_groups
from torch_scenes import REPO

TOL = 1e-3  # rtol and atol of the reference's test_glass_scene_grads


def glass_scene_text():
    """The ``GLASS_SCENE`` of the reference's ``tests/test_vjp_kernel.py``."""
    with open(f"{REPO}/tests/test_vjp_kernel.py") as f:
        return f.read().split('GLASS_SCENE = """\\\n')[1].split('"""')[0]


def test_plain_k8_matches_the_interpret_kernel_on_glass():
    js = dataclasses.replace(pt.parse_scene(glass_scene_text()),
                             trace_depth=3)
    scene = convert.from_jax_scene(js)
    ct = np.random.RandomState(5).rand(js.pixel_count, 3).astype(np.float32)
    rad_ref, gref = render_vjp_pallas(js, ct, 1, 1, interpret=True)
    rad, g = VJ.render_vjp(scene, ct, 1, 1, device="cpu")
    # no tie flip at this size: every pixel's cotangent is compared
    np.testing.assert_allclose(rad.numpy(), np.asarray(rad_ref), rtol=0,
                               atol=1e-4)
    got, want = grad_groups(g), grad_groups(gref)
    assert np.abs(want["materials.color"]).max() > 0
    for name in sorted(want):
        assert np.isfinite(got[name]).all(), name
    for name in ("materials.ior", "materials.color", "materials.spec_color"):
        np.testing.assert_allclose(got[name], want[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
