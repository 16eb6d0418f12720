"""K8's plain version against the reference's kernel in interpret mode.

``render_vjp_pallas(..., interpret=True, nee=True)`` (the Pallas
``_vjp_kernel``, its reverse sweep by ``jax.vjp`` of the tracer) and the
port's ``render_vjp(..., device="cpu")`` on the rig of
``tests/test_vjp_kernel.py`` at 8x8 depth 2, one sample: the radiance
within 1e-4 on every pixel, and every parameter group to rtol 2e-4 /
atol 3e-4, the reference's own tolerance.  One call of the reference
takes about a minute on the CPU, so this is the only such case; the
others hold the port against the planes engine
(``tests/test_torch_vjp.py``).
"""

import numpy as np
import torch

from pathtrace_tpu.ops.pallas.megakernel import render_vjp_pallas
from pathtrace_tpu_torch.ops.cuda import vjp as VJ
from pathtrace_tpu_torch.render import diff as D

from test_torch_vjp import ATOL, RTOL, grad_groups, rig


def test_plain_k8_matches_the_interpret_kernel():
    js, scene = rig(res=(8, 8), depth=2)
    ct = np.random.RandomState(0).rand(64, 3).astype(np.float32)
    rad_ref, gref = render_vjp_pallas(js, ct, 1, 1, interpret=True, nee=True)
    rad, g = VJ.render_vjp(scene, ct, 1, 1, nee=True, device="cpu")
    # no tie flip at this size: every pixel's cotangent is compared
    np.testing.assert_allclose(rad.numpy(), np.asarray(rad_ref), rtol=0,
                               atol=1e-4)
    got = grad_groups(g)
    want = grad_groups(gref)
    assert set(got) == set(want)
    assert np.abs(want["translation"]).max() > 0.1
    for name in sorted(want):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert all(bool(torch.isfinite(t).all()) for t in D.leaves(g))
