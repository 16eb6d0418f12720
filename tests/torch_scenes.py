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
# cornell_mesh.txt: its icosahedron (material 4) made glass with a checker,
# and moving (glass, checker and motion sections on a MESH geom)
MESH_GLASS = ("REFR        0\nREFRIOR     0\nEMITTANCE   0\n\n// Camera",
              "REFR        1\nREFRIOR     1.5\nEMITTANCE   0\n"
              "CHECKER     3 .2 .4 .9\n\n// Camera")
MESH_MOTION = ("SCALE       2 2 2", "SCALE       2 2 2\nMOTION      .6 0 .3")
# BUMP on the icosahedron
MESH_BUMP = ("EMITTANCE   0\n\n// Camera",
             "EMITTANCE   0\nBUMP        3 0.5\n\n// Camera")
# a second instance of the icosahedron, white, tilted and squashed
MESH_TWICE = ("SCALE       2 2 2", "SCALE       2 2 2\n\nOBJECT 7\n"
              "mesh icosahedron.obj\nmaterial 1\nTRANS       -2.5 6 0.5\n"
              "ROTAT       10 0 45\nSCALE       1.5 .8 1.5")

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
# the triangle-mesh configurations (K3), same layout
MESH_CONFIGS = {
    "cornell_mesh": ("cornell_mesh", (), False, False),
    "cornell_bigmesh": ("cornell_bigmesh", (), False, False),
    "cornell_mesh-nee": ("cornell_mesh", (), True, False),
    "cornell_mesh-rr": ("cornell_mesh", (), False, True),
    "mesh_glass_checker_motion": ("cornell_mesh", (MESH_GLASS, MESH_MOTION),
                                  False, False),
    "mesh_bump": ("cornell_mesh", (MESH_BUMP,), False, False),
    "mesh_twice": ("cornell_mesh", (MESH_TWICE,), False, False),
}


def scene_text(name, edits=()):
    with open(os.path.join(REPO, "scenes", f"{name}.txt")) as f:
        text = f.read()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def load(name, edits=(), res=None, depth=None):
    s = ptt.parse_scene(scene_text(name, edits),
                        base_dir=os.path.join(REPO, "scenes"))
    return dataclasses.replace(s, resolution=res or s.resolution,
                               trace_depth=depth or s.trace_depth)


def job(config, res, depth, device="cpu"):
    """``trace_k1``/``trace_plain`` keyword arguments for ``config`` (of
    ``CONFIGS`` or ``MESH_CONFIGS``)."""
    name, edits, nee, rr = {**CONFIGS, **MESH_CONFIGS}[config]
    return K.prepare(load(name, edits, res, depth), device, nee=nee, rr=rr)
