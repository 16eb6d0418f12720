"""Host scene model, counter RNG and vector math."""

from . import constants, rng, types, vecmath
