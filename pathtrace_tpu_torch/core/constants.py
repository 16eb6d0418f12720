"""Numeric constants shared across the framework.

Mirrors the constants the reference keeps in ``src/utilities.h:12-15``
(PI, TWO_PI, SQRT_OF_ONE_THIRD, EPSILON) plus the self-intersection
offset used by ``getPointOnRay`` (``src/intersections.h:26-28``).
"""

PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
EPSILON = 0.00001

# getPointOnRay falls short of the surface by this much along the
# normalized ray direction (src/intersections.h:27).
RAY_OFFSET = 1e-4

# Sentinel distance for "no hit" when reducing over geometries.
NO_HIT = 1e30

# Transmission push: refracted continuations advance past the interface
# by this factor times the geom's max |scale| (must exceed the
# object-space RAY_OFFSET backoff, stay below thin-wall thickness).
TRANSMISSION_PUSH = 5e-4
