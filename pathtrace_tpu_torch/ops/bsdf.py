"""Branchless BSDF sampling, in float32 torch.

Counterpart of ``pathtrace_tpu/ops/bsdf.py`` (the reference's
``scatterRay``, ``src/interactions.h``): choose a lobe at random and
divide the chosen branch's contribution by its probability.

* ``has_refractive > 0``: Fresnel glass.  Reflect with the Schlick
  probability R, else refract (Snell's law, ``glm::refract``); total
  internal reflection falls back to the mirror.  Reflection tints by
  SPECRGB, refraction by RGB.
* else ``has_reflective > 0``: specular with probability p =
  has_reflective (throughput x SPECRGB / p), diffuse otherwise
  (throughput x RGB / (1 - p)).  SPECEX > 0 makes the specular direction
  a power-cosine sample about the mirror direction.
* else cosine-weighted diffuse (sqrt(u1) altitude, the Peter-Kutz
  tangent frame).

Every lobe is evaluated for every ray and selected with ``where``.  The
discrete choices depend on the draws and on detached comparisons only,
so gradients flow through the continuous factors, as detached sampling
prescribes.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.constants import SQRT_OF_ONE_THIRD, TWO_PI


def _kutz_frame(normal):
    """Tangent frame (p1, p2) about ``normal`` (N,3) by the Peter-Kutz
    axis choice."""
    ax = torch.abs(normal[..., 0:1])
    ay = torch.abs(normal[..., 1:2])
    e = torch.eye(3, dtype=normal.dtype, device=normal.device)
    not_normal = torch.where(ax < SQRT_OF_ONE_THIRD, e[0],
                             torch.where(ay < SQRT_OF_ONE_THIRD, e[1], e[2]))
    p1 = vm.normalize(vm.cross(normal, not_normal), eps=1e-20)
    p2 = vm.normalize(vm.cross(normal, p1), eps=1e-20)
    return p1, p2


def cosine_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` (N,3); u1, u2 (N,)."""
    up = torch.sqrt(u1)[..., None]                       # cos(theta)
    over = torch.sqrt(vm.maximum(1.0 - up * up, 0.0))  # sin(theta)
    around = (u2 * TWO_PI)[..., None]
    p1, p2 = _kutz_frame(normal)
    return (up * normal + torch.cos(around) * over * p1
            + torch.sin(around) * over * p2)


def power_cosine_about(axis, exponent, u1, u2):
    """Power-cosine direction about ``axis`` (GPU Gems 3 ch. 20 eq. 7-9):
    theta = acos(u1^(1/(n+1))), phi = 2 pi u2."""
    n1 = 1.0 / (exponent + 1.0)
    cos_t = torch.pow(vm.maximum(u1, 1e-12), n1)[..., None]
    sin_t = torch.sqrt(vm.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = (u2 * TWO_PI)[..., None]
    p1, p2 = _kutz_frame(axis)
    return (cos_t * axis + torch.cos(phi) * sin_t * p1
            + torch.sin(phi) * sin_t * p2)


def schlick_reflectance(cos_i, ior):
    """Schlick's R(cos_i), R0 = ((1 - ior) / (1 + ior))^2."""
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    m = vm.maximum(1.0 - cos_i, 0.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def sample_bsdf(wi, normal, outside, mat, u):
    """Scatter one bounce of every ray.

    ``wi`` (N,3): incoming directions, toward the surface; ``normal``
    (N,3): facing the incoming ray; ``outside`` (N,) bool; ``mat``: the
    per-ray material fields color, spec_color (N,3) and spec_exponent,
    has_reflective, has_refractive, ior (N,); ``u``: the draws lobe,
    diff_u1, diff_u2, fresnel, spec_u1, spec_u2 (N,).

    Returns (new_dir (N,3), throughput multiplier (N,3), took_diffuse
    (N,) bool: the diffuse lobe was sampled (NEE cancels the emission
    such a ray finds next), took_refract (N,) bool: the ray passed the
    refractive interface (SSS tracks the medium by it))."""
    color = mat["color"]
    spec_color = mat["spec_color"]

    # diffuse lobe
    d_diff = cosine_hemisphere(normal, u["diff_u1"], u["diff_u2"])

    # specular lobe, perfect or imperfect
    d_mirror = vm.reflect(wi, normal)
    d_imperfect = power_cosine_about(d_mirror, mat["spec_exponent"],
                                     u["spec_u1"], u["spec_u2"])
    d_spec = torch.where((mat["spec_exponent"] > 0.0)[..., None],
                         d_imperfect, d_mirror)

    # refractive lobe: Schlick-weighted reflect or refract
    cos_i = vm.clip(-vm.dot(normal, wi)[..., 0], 0.0, 1.0)
    refl_prob = schlick_reflectance(cos_i, mat["ior"])
    eta = torch.where(outside, 1.0 / vm.maximum(mat["ior"], 1e-6),
                      mat["ior"])
    d_refr = vm.refract(wi, normal, eta[..., None])
    tir = torch.sum(d_refr * d_refr, dim=-1) < 1e-12
    choose_reflect = (u["fresnel"] < refl_prob) | tir
    d_fresnel = torch.where(choose_reflect[..., None], d_mirror, d_refr)
    t_fresnel = torch.where(choose_reflect[..., None], spec_color, color)

    # specular / diffuse split
    p_spec = vm.clip(mat["has_reflective"], 0.0, 1.0)
    take_spec = u["lobe"] < p_spec
    p_safe = vm.maximum(torch.where(take_spec, p_spec, 1.0 - p_spec),
                        1e-8)[..., None]
    d_sd = torch.where(take_spec[..., None], d_spec, d_diff)
    t_sd = torch.where(take_spec[..., None], spec_color, color) / p_safe

    # by material class
    is_glass = mat["has_refractive"] > 0.0
    new_dir = torch.where(is_glass[..., None], d_fresnel, d_sd)
    thr = torch.where(is_glass[..., None], t_fresnel, t_sd)
    return new_dir, thr, ~take_spec & ~is_glass, is_glass & ~choose_reflect
