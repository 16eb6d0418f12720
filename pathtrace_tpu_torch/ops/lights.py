"""Area-light sampling for next-event estimation (NEE), in float32 torch.

Counterpart of ``pathtrace_tpu/ops/lights.py``.  The tables, the
per-face geometry of a cube light and the ``|det M3|`` of a sphere
light, are what ``ops/cuda/megakernel.pack_lights`` writes into the
light table that the megakernel's NEE section samples; the samplers and
:func:`nee_contribution` are the wavefront's
(``render/integrator._nee_direct``).  Sums of three or six terms are
added left to right, as the reference's reductions add them; a cube's
six faces are computed at once, as (6,3) tensors.

Sampling measure: uniform by area on the light.  A cube light picks a
face with probability in proportion to its world-space area, then a
point on that parallelogram; a sphere light maps a uniform unit-sphere
direction through its transform and weights it by the exact area
Jacobian ``pi |det M| |M^-T w|``, right for any linear transform.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.constants import PI, TWO_PI


# the faces in the order +x, -x, +y, -y, +z, -z: each face's axis, the
# two edge axes after it, and its side of the cube
_FACE_AXIS = torch.tensor([0, 0, 1, 1, 2, 2])
_FACE_B = (_FACE_AXIS + 1) % 3
_FACE_C = (_FACE_AXIS + 2) % 3
_FACE_SIGN = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0, -1.0])


def _cols(fwd_g):
    """The columns of the linear part of a (4,4) or (3,4) transform, as
    the rows of a (3,3)."""
    return fwd_g[:3, :3].transpose(0, 1)


def cube_light_tables(fwd_g):
    """Per-face (origin, edge_b, edge_c, outward normal, area) for the 6
    faces of a transformed unit cube.  ``fwd_g``: (4,4) or (3,4) float32.
    Returns a dict of (6,3) / (6,) tensors, faces in the order +x, -x,
    +y, -y, +z, -z, all six at once."""
    dev = fwd_g.device
    cols = _cols(fwd_g)
    sign = _FACE_SIGN.to(dev)
    e_b, e_c = cols[_FACE_B.to(dev)], cols[_FACE_C.to(dev)]
    axis = cols[_FACE_AXIS.to(dev)]
    cross = vm.cross(e_b, e_c)
    area = torch.sqrt(vm.sum3(cross * cross))
    center = fwd_g[:3, 3] + axis * (0.5 * sign)[:, None]
    # orient the plane normal cross(Mb, Mc) outward: along
    # sign * (world direction of +axis)
    orient = vm.sum3(cross * axis)
    n = cross * (torch.where(orient >= 0, 1.0, -1.0) * sign)[:, None]
    n = n / torch.clamp_min(torch.sqrt(vm.sum3(n * n)), 1e-20)[:, None]
    return dict(origin=center, e_b=e_b, e_c=e_c, normal=n, area=area)


def sphere_det3(fwd_g):
    """|det| of the linear 3x3 part of a (4,4) or (3,4) transform, ()."""
    c0, c1, c2 = _cols(fwd_g).unbind(0)
    return torch.abs(vm.sum3(c0 * vm.cross(c1, c2)))


def sample_cube_light(fwd_g, u_sel, u, v):
    """A point uniform by area on a transformed unit cube: ``fwd_g``
    (4,4), draws (N,).  Returns (point (N,3), normal (N,3), total area
    ())."""
    tab = cube_light_tables(fwd_g)
    total = torch.sum(tab["area"])
    cdf = torch.cumsum(tab["area"], dim=0) / vm.maximum(total, 1e-20)
    s = u - 0.5
    t = v - 0.5
    point = u.new_zeros((u.shape[0], 3))
    normal = u.new_zeros((u.shape[0], 3))
    prev = torch.zeros_like(cdf[0])
    for f in range(6):
        hi = cdf[f]
        m = ((u_sel >= prev) & (u_sel < hi)) if f < 5 else (u_sel >= prev)
        p_f = (tab["origin"][f][None] + s[:, None] * tab["e_b"][f][None]
               + t[:, None] * tab["e_c"][f][None])
        point = torch.where(m[:, None], p_f, point)
        normal = torch.where(m[:, None], tab["normal"][f][None], normal)
        prev = hi
    return point, normal, total


def sample_sphere_light(fwd_g, inv_t_g, u, v):
    """A point on a transformed sphere (r = 0.5) from a uniform direction
    w, with its exact inverse pdf: the map w -> M (w / 2) + t has area
    element |det M| |M^-T w| / 4 dOmega, so the weight is pi |det M|
    |M^-T w|.  Returns (point (N,3), normal (N,3), weight (N,))."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt(vm.maximum(1.0 - z * z, 0.0))
    phi = v * TWO_PI
    w = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    point = vm.transform_point(fwd_g, 0.5 * w)
    n_raw = vm.transform_dir(inv_t_g, w)                # M^-T w
    n_len = vm.norm(n_raw)[..., 0]
    normal = n_raw / vm.maximum(n_len, 1e-20)[:, None]
    return point, normal, PI * sphere_det3(fwd_g) * n_len


def nee_contribution(point, normal, albedo, throughput, light_point,
                     light_normal, light_area, light_emission, occluded):
    """Direct light through one sampled light point: the diffuse lobe
    albedo / pi, the geometric term cos_s cos_l / r^2, pdf 1 / area;
    zero where ``occluded``.  Rays (N,3) / (N,); ``light_emission`` (3,)
    or (N,3)."""
    wl = light_point - point
    r2_safe = vm.maximum(torch.sum(wl * wl, dim=-1), 1e-8)
    wl_n = wl / torch.sqrt(r2_safe)[:, None]
    cos_s = vm.maximum(torch.sum(normal * wl_n, dim=-1), 0.0)
    cos_l = vm.maximum(torch.sum(light_normal * (-wl_n), dim=-1), 0.0)
    g = cos_s * cos_l / r2_safe
    contrib = (throughput * (albedo * (1.0 / PI)) * light_emission
               * (g * light_area)[:, None])
    return torch.where(occluded[:, None], 0.0, contrib)
