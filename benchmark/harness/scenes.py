"""A configuration's scene as the program reads it: the scene file in
the course's text format, written from the configuration's numbers, and
the OBJ files its mesh objects name (``meshes.py``), in a fixed
directory of the checkout.

A material writes ``RGB``, ``SPECEX``, ``SPECRGB``, ``REFL``, ``REFR``,
``REFRIOR`` and ``EMITTANCE``; the camera ``RES``, ``FOVY``,
``ITERATIONS``, ``DEPTH``, ``FILE``, ``EYE``, ``VIEW``, ``UP`` and, where
it carries ``aperture`` and ``focal``, the thin lens's ``APERTURE`` and
``FOCAL``; an object its shape (a mesh with its OBJ), ``material``,
``TRANS``, ``ROTAT`` and ``SCALE``.  Any other key, such as a checker,
bump, subsurface, motion or texture that the reference does not trace,
raises ``ValueError`` naming it (``reference/tables.check_config``), so no
feature reaches the program unseen by the reference."""

from __future__ import annotations

import os

from ..reference.tables import check_config
from . import meshes


def _nums(v):
    return " ".join(repr(float(x)) for x in v)


def scene_text(cfg, obj_names):
    """The scene file of configuration ``cfg``; ``obj_names`` maps each
    mesh object's index to its OBJ file's name, beside the scene file.
    Raises ``ValueError`` for a key it does not write."""
    check_config(cfg)
    out = []
    for i, m in enumerate(cfg["materials"]):
        out += [f"MATERIAL {i}", f"RGB {_nums(m['rgb'])}",
                f"SPECEX {m['specex']!r}", f"SPECRGB {_nums(m['specrgb'])}",
                f"REFL {m['refl']!r}", f"REFR {m['refr']!r}",
                f"REFRIOR {m['refrior']!r}",
                f"EMITTANCE {m['emittance']!r}", ""]
    c = cfg["camera"]
    out += ["CAMERA", f"RES {c['res'][0]} {c['res'][1]}",
            f"FOVY {c['fovy']!r}", f"ITERATIONS {c['iterations']}",
            f"DEPTH {c['depth']}", f"FILE {c['file']}",
            f"EYE {_nums(c['eye'])}", f"VIEW {_nums(c['view'])}",
            f"UP {_nums(c['up'])}"]
    if "aperture" in c:
        out += [f"APERTURE {c['aperture']!r}", f"FOCAL {c['focal']!r}"]
    out += [""]
    for i, o in enumerate(cfg["objects"]):
        shape = o["shape"] + (f" {obj_names[i]}" if o["shape"] == "mesh"
                              else "")
        out += [f"OBJECT {i}", shape, f"material {o['material']}",
                f"TRANS {_nums(o['trans'])}", f"ROTAT {_nums(o['rotat'])}",
                f"SCALE {_nums(o['scale'])}", ""]
    return "\n".join(out)


def write_scene(cfg, directory):
    """Writes configuration ``cfg``'s scene file and OBJ files into
    ``directory``; returns (the scene file's path, {mesh object index:
    its OBJ's path})."""
    os.makedirs(directory, exist_ok=True)
    obj_names, obj_paths = {}, {}
    for i, o in enumerate(cfg["objects"]):
        if o["shape"] == "mesh":
            spec = o["obj"]
            name = f"{spec['generator']}{spec.get('level', '')}_{i}.obj"
            obj_names[i] = name
            obj_paths[i] = os.path.join(directory, name)
            meshes.write(spec, obj_paths[i])
    path = os.path.join(directory, f"{cfg['name']}.txt")
    with open(path, "w") as f:
        f.write(scene_text(cfg, obj_names))
    return path, obj_paths
