"""Variants of the shipped scene files, made by editing their text.

Each variant is a tuple of ``(old, new)`` replacements, and
:func:`edit_text` applies them, each of which must occur exactly once.
``chip_smoke.py`` renders and times these variants on the GPU, and the
tests check them on the CPU.  ``TEX512`` builds cornell_tex512: this is
the scene of the reference bench's secondary metric, which the bench
builds from cornell_tex.txt in the same way.
"""

from __future__ import annotations

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
# cornell_tex.txt with the 512x512 pattern (cornell_tex512)
TEX512 = ("tex/pattern32.png", "tex/pattern512.png")
# cornell_tex.txt: a checker on its textured material (the odd cells
# replace the textured albedo)
TEX_CHECKER = ("EMITTANCE   0\nTEXTURE     tex/pattern32.png",
               "EMITTANCE   0\nTEXTURE     tex/pattern32.png\n"
               "CHECKER     4 .9 .2 .2")
# cornell_bumpmesh.txt: a TEXTURE beside its BUMPTEX on the UV-mapped
# grid plane (vt interpolation on a mesh)
MESH_TEX = ("BUMPTEX     tex/bumps16.png 1.5",
            "TEXTURE     tex/pattern32.png\nBUMPTEX     tex/bumps16.png 1.5")


def edit_text(text, edits):
    """``text`` with each ``(old, new)`` of ``edits`` replaced; raises
    ``ValueError`` unless each ``old`` occurs exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"the replacement must match once: {old!r}")
        text = text.replace(old, new)
    return text
