"""Scene configurations for the port's feature tests (CPU and GPU).

The shipped scene files, and variants built from their text with
asserted replacements.  Imports no JAX, so the GPU-only tests can use it
where JAX is not installed.
"""

import dataclasses
import os

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# BUMP on cornell_glass's diffuse white (floor, ceiling, back wall)
BUMP = ("EMITTANCE   0\n\n// Diffuse red",
        "EMITTANCE   0\nBUMP        2 0.6\n\n// Diffuse red")
# a dense medium in cornell_glass's glass sphere: SSS acts only on paths
# that refracted into a medium
SSS = ("REFRIOR     1.5\nEMITTANCE   0\n",
       "REFRIOR     1.5\nEMITTANCE   0\nSSS         6.0 .9 .6 .4\n")
# cornell.txt with a sphere for its ceiling light (NEE's sphere branch)
SPHERE_LIGHT = ("OBJECT 0\ncube\nmaterial 0", "OBJECT 0\nsphere\nmaterial 0")

# name -> (scene file, text replacements, nee, rr)
CONFIGS = {
    "cornell": ("cornell", (), False, False),
    "cornell-nee": ("cornell", (), True, False),
    "cornell-rr": ("cornell", (), False, True),
    "cornell_glass": ("cornell_glass", (), False, False),
    "cornell_glass-nee": ("cornell_glass", (), True, False),
    "cornell_checker": ("cornell_checker", (), False, False),
    "bump": ("cornell_glass", (BUMP,), False, False),
    "sss": ("cornell_glass", (SSS,), False, False),
    "sphere_light-nee": ("cornell", (SPHERE_LIGHT,), True, False),
}


def scene_text(name, edits=()):
    with open(os.path.join(REPO, "scenes", f"{name}.txt")) as f:
        text = f.read()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def load(name, edits=(), res=None, depth=None):
    s = ptt.parse_scene(scene_text(name, edits))
    return dataclasses.replace(s, resolution=res or s.resolution,
                               trace_depth=depth or s.trace_depth)


def job(config, res, depth, device="cpu"):
    """``trace_k1``/``trace_plain`` keyword arguments for ``config``."""
    name, edits, nee, rr = CONFIGS[config]
    return K.prepare(load(name, edits, res, depth), device, nee=nee, rr=rr)
