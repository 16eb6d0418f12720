"""Camera basis and geom transforms in float32 torch.

Counterpart of the two helpers of ``pathtrace_tpu/render/integrator.py``
that the megakernel's table packing uses; the rest of that module (the
wavefront integrator) is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.constants import PI
from ..core.vecmath import as_f32 as _f32


def camera_basis(camera, width, height):
    """(view, right, up, tan_fovx, tan_fovy), fovx derived from fovy and
    the aspect ratio as src/scene.cpp:133-136 does."""
    view = vm.normalize(_f32(camera.view))
    right = vm.normalize(vm.cross(view, _f32(camera.up)))
    up = vm.normalize(vm.cross(right, view))
    tan_y = torch.tan(_f32(camera.fovy_deg) * (PI / 180.0))
    tan_x = tan_y * (width / height)
    return view, right, up, tan_x, tan_y


def geom_transforms(geoms):
    """TRS -> (forward, inverse, inverse-transpose), (G,4,4) each — the
    precompute of src/scene.cpp:82-85."""
    t, r, s = (_f32(geoms.translation), _f32(geoms.rotation),
               _f32(geoms.scale))
    fwd = vm.trs_matrix(t, r, s)
    inv = vm.trs_inverse(t, r, s)
    return fwd, inv, inv.transpose(-1, -2)
