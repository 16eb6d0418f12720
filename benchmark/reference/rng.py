"""Counter-based RNG: every random draw is a pure function of
``(iter, pixel, depth, draw)`` (pcg4d-style mixing).

A frozen copy of the port's counter RNG, kept here so that the
reference draws the same numbers without importing the program.  Each
u32 value is held in an int64 tensor and masked with ``& 0xFFFFFFFF``
after every add and multiply (PyTorch has no u32 ``+`` or ``>>`` on the
CPU); an int64 product of two u32 values may wrap, but its low 32 bits,
the only ones kept, are right.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _u32(x):
    """A u32 counter as an int64 tensor, or as a Python int (kept on
    the host, so a scalar counter costs no device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(np.asarray(x).astype(np.int64)) & _M32


def _lcg(x):
    return (x * 1664525 + 1013904223) & _M32


def _mix4(a, b, c, d):
    """pcg4d-style 4-lane avalanche mix on int64-held u32 values."""
    a, b, c, d = _lcg(a), _lcg(b), _lcg(c), _lcg(d)
    a = (a + b * d) & _M32
    b = (b + c * a) & _M32
    c = (c + a * b) & _M32
    d = (d + b * c) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + b * d) & _M32
    b = (b + c * a) & _M32
    c = (c + a * b) & _M32
    d = (d + b * c) & _M32
    return a, b, c, d


def hash_u32(it, pixel, depth, draw):
    """u32 hash of the 4-tuple counter, held in int64 in [0, 2^32).
    Arguments are ints, integer arrays or integer tensors; broadcasting
    applies."""
    a, b, c, d = _mix4(*(_u32(x) for x in (it, pixel, depth, draw)))
    return a ^ d


def uniform(it, pixel, depth, draw):
    """U[0,1) float32 from the top 24 bits of :func:`hash_u32`: exactly
    representable in float32 and never 1.0."""
    top24 = torch.as_tensor(hash_u32(it, pixel, depth, draw) >> 8)
    return top24.to(torch.float32) * (1.0 / 16777216.0)


class Draw:
    """Fixed draw-slot layout per (iter, pixel, depth) stream.  Depth
    slot 0 is camera-ray generation; bounce d uses depth slot d+1."""

    AA_X = 0          # antialias jitter in x (raygen)
    AA_Y = 1          # antialias jitter in y (raygen)
    DOF_U = 2         # depth-of-field aperture sample u (raygen)
    DOF_V = 3         # depth-of-field aperture sample v (raygen)
    TIME = 4          # shutter-time jitter (raygen; motion blur)
    LOBE = 0          # BSDF lobe selection (bounce)
    DIFF_U1 = 1       # cosine-weighted hemisphere u1
    DIFF_U2 = 2       # cosine-weighted hemisphere u2
    FRESNEL = 3       # Schlick reflect-vs-refract choice
    SPEC_U1 = 4       # imperfect-specular u1
    SPEC_U2 = 5       # imperfect-specular u2
    RR = 6            # russian roulette (optional)
    SSS_STEP = 8      # medium free-path sample (subsurface scattering)
    SSS_U = 9         # isotropic phase function u
    SSS_V = 10        # isotropic phase function v
    NEE_BASE = 16     # light k uses draws NEE_BASE+3k .. +3k+2
