"""Texel gradients of the port's planes engine against ``jax.grad`` of the
reference's (``render/plane_engine.pathtrace_iteration_planes``), run as
``tests/test_planes.py::test_texel_gradients_planes`` runs it, on the rig
and at the tolerance of ``tests/test_torch_texel_grad.py`` (which says
why).  A file of its own: the reference's compile takes a minute or two.
"""

import numpy as np

from pathtrace_tpu.render.plane_engine import pathtrace_iteration_planes
from pathtrace_tpu_torch.render import diff as D

from test_torch_texel_grad import (
    ATOL_REFERENCE, RTOL, port_texel_grad, reference_texel_grad,
    texel_scenes,
)


def test_texel_gradients_planes_match_reference():
    js, scene, tid = texel_scenes()
    got = port_texel_grad(scene, tid, D.planes_iteration)
    want = reference_texel_grad(js, tid, pathtrace_iteration_planes)
    assert np.abs(got).sum() > 0 and np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REFERENCE)
