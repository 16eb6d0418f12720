"""Scene-file parser: the reference's text grammar, SoA numpy output.

Counterpart of ``pathtrace_tpu/scene/parser.py``: the
line-oriented format of ``src/scene.cpp`` + README.md:203-246 with the
same extensions (CHECKER / BUMP / SSS material lines, MOTION object
key, APERTURE / FOCAL camera keys, ``mesh <path.obj>`` objects, their
triangles read by ``scene/obj.py`` and given a BVH by ``scene/bvh.py``)
and the same arrays.  ``TEXTURE`` / ``BUMPTEX`` material lines are
consumed by the material block and loaded afterwards by
``scene/textures.attach_textures``.  :func:`load_scene` parses with
the C++ parser of ``native/`` when its library builds.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..core import types as T
from ..core.constants import PI
from .bvh import with_bvh
from .obj import load_obj
from .textures import attach_textures


class SceneParseError(ValueError):
    pass


def _safe_lines(text: str) -> List[str]:
    # CR/LF/CRLF-safe, like utilityCore::safeGetline (src/utilities.cpp:82-112)
    return text.replace("\r\n", "\n").replace("\r", "\n").split("\n")


def _vec3(t):
    return (float(t[1]), float(t[2]), float(t[3]))


def load_scene(path: str, native: Optional[bool] = None) -> T.Scene:
    """Load a scene file, as the reference's ``load_scene``: with the C++
    parser (``native/lib.py``, the same scene) when its library builds
    and ``native`` is None; with :func:`parse_scene` when ``native`` is
    False or ``PT_NO_NATIVE=1``; with the C++ parser when ``native`` is
    True, raising ``native.lib.NativeError`` when its library cannot be
    built or loaded."""
    if native is not False:
        from ..native import lib as N

        if native or N.available():
            return N.parse_scene_native(path=path)
    with open(path, "r") as f:
        text = f.read()
    return parse_scene(text, base_dir=os.path.dirname(os.path.abspath(path)))


def parse_scene(text: str, base_dir: str = ".") -> T.Scene:
    """``base_dir`` resolves relative OBJ and texture paths."""
    lines = _safe_lines(text)
    pos = 0

    materials: List[dict] = []
    geoms: List[dict] = []
    camera: Optional[dict] = None
    mesh_tris: List[np.ndarray] = []
    mesh_uvs: List[np.ndarray] = []
    mesh_geom_ids: List[np.ndarray] = []
    any_mesh_uv = False

    def next_line():
        nonlocal pos
        if pos >= len(lines):
            return None
        pos += 1
        return lines[pos - 1]

    while True:
        line = next_line()
        if line is None:
            break
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "MATERIAL":
            mat_id = int(toks[1])
            if mat_id != len(materials):
                raise SceneParseError(
                    f"MATERIAL ID {mat_id} does not match expected "
                    f"{len(materials)} (sequential IDs required)"
                )
            m = dict(
                color=(0.0, 0.0, 0.0), spec_exponent=0.0,
                spec_color=(0.0, 0.0, 0.0), has_reflective=0.0,
                has_refractive=0.0, ior=0.0, emittance=0.0,
                checker_scale=0.0, checker_color=(0.0, 0.0, 0.0),
                bump_scale=0.0, bump_strength=0.0,
                sss_sigma=0.0, sss_albedo=(0.0, 0.0, 0.0),
            )
            for _ in range(7):  # exactly 7 property lines (src/scene.cpp:157)
                t = (next_line() or "").split()
                if not t:
                    continue
                key = t[0]
                if key == "RGB":
                    m["color"] = _vec3(t)
                elif key == "SPECEX":
                    m["spec_exponent"] = float(t[1])
                elif key == "SPECRGB":
                    m["spec_color"] = _vec3(t)
                elif key == "REFL":
                    m["has_reflective"] = float(t[1])
                elif key == "REFR":
                    m["has_refractive"] = float(t[1])
                elif key == "REFRIOR":
                    m["ior"] = float(t[1])
                elif key == "EMITTANCE":
                    m["emittance"] = float(t[1])
            # optional extension lines after the 7 fixed ones (malformed
            # ones are skipped, like any unknown token)
            while pos < len(lines):
                peek = lines[pos].split()
                if peek and peek[0] == "CHECKER" and len(peek) >= 5:
                    pos += 1
                    m["checker_scale"] = float(peek[1])
                    m["checker_color"] = _vec3(peek[1:])
                elif peek and peek[0] == "BUMP" and len(peek) >= 3:
                    pos += 1
                    m["bump_scale"] = float(peek[1])
                    m["bump_strength"] = float(peek[2])
                elif peek and peek[0] == "SSS" and len(peek) >= 5:
                    pos += 1
                    m["sss_sigma"] = float(peek[1])
                    m["sss_albedo"] = _vec3(peek[1:])
                elif peek and peek[0] in ("TEXTURE", "BUMPTEX"):
                    # consumed here so the block reader stays aligned;
                    # attach_textures reads them from the text below
                    pos += 1
                else:
                    break
            materials.append(m)
        elif toks[0] == "OBJECT":
            obj_id = int(toks[1])
            if obj_id != len(geoms):
                raise SceneParseError(
                    f"OBJECT ID {obj_id} does not match expected "
                    f"{len(geoms)} (sequential IDs required)"
                )
            type_line = (next_line() or "").split()
            gtype, mesh_path = None, None
            if type_line:
                if type_line[0] == "sphere":
                    gtype = T.SPHERE
                elif type_line[0] == "cube":
                    gtype = T.CUBE
                elif type_line[0] == "mesh":
                    gtype = T.MESH
                    if len(type_line) < 2:
                        raise SceneParseError(
                            "mesh object requires an OBJ path")
                    mesh_path = type_line[1]
            if gtype is None:
                raise SceneParseError(f"unknown object type: {type_line}")
            mat_line = (next_line() or "").split()
            g = dict(
                type=gtype, material_id=int(mat_line[1]),
                translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0),
                scale=(1.0, 1.0, 1.0), velocity=(0.0, 0.0, 0.0),
            )
            while True:
                t_line = next_line()
                if t_line is None or not t_line.split():
                    break
                t = t_line.split()
                if t[0] == "TRANS":
                    g["translation"] = _vec3(t)
                elif t[0] == "ROTAT":
                    g["rotation"] = _vec3(t)
                elif t[0] == "SCALE":
                    g["scale"] = _vec3(t)
                elif t[0] == "MOTION":
                    g["velocity"] = _vec3(t)
            if gtype == T.MESH:
                tris, uvs = load_obj(os.path.join(base_dir, mesh_path))
                mesh_tris.append(tris)
                any_mesh_uv = any_mesh_uv or uvs is not None
                mesh_uvs.append(uvs if uvs is not None else np.zeros(
                    (tris.shape[0], 3, 2), dtype=np.float32))
                mesh_geom_ids.append(
                    np.full((tris.shape[0],), len(geoms), dtype=np.int32))
            geoms.append(g)
        elif toks[0] == "CAMERA":
            cam = dict(
                resolution=(800, 800), fovy=45.0, iterations=10, depth=8,
                file="render", eye=(0.0, 0.0, 0.0), view=(0.0, 0.0, -1.0),
                up=(0.0, 1.0, 0.0), aperture=0.0, focal=1.0,
            )
            for _ in range(5):  # RES FOVY ITERATIONS DEPTH FILE
                t = (next_line() or "").split()
                if not t:
                    continue
                if t[0] == "RES":
                    cam["resolution"] = (int(t[1]), int(t[2]))
                elif t[0] == "FOVY":
                    cam["fovy"] = float(t[1])
                elif t[0] == "ITERATIONS":
                    cam["iterations"] = int(t[1])
                elif t[0] == "DEPTH":
                    cam["depth"] = int(t[1])
                elif t[0] == "FILE":
                    cam["file"] = t[1]
            while True:
                t_line = next_line()
                if t_line is None or not t_line.split():
                    break
                t = t_line.split()
                if t[0] == "EYE":
                    cam["eye"] = _vec3(t)
                elif t[0] == "VIEW":
                    cam["view"] = _vec3(t)
                elif t[0] == "UP":
                    cam["up"] = _vec3(t)
                elif t[0] == "APERTURE":
                    cam["aperture"] = float(t[1])
                elif t[0] == "FOCAL":
                    cam["focal"] = float(t[1])
            camera = cam

    if camera is None:
        raise SceneParseError("scene file has no CAMERA block")
    if not materials:
        raise SceneParseError("scene file has no materials")
    if not geoms:
        raise SceneParseError("scene file has no objects")
    for g in geoms:
        if not (0 <= g["material_id"] < len(materials)):
            raise SceneParseError(
                f"object references material {g['material_id']} "
                f"but only {len(materials)} materials are defined"
            )

    f32 = np.float32

    def col(key):
        return np.asarray([m[key] for m in materials], dtype=f32)

    def optional(key, gate):
        # an extension's arrays exist only when some material uses it
        return col(key) if any(m[gate] for m in materials) else None

    mats = T.Materials(
        color=col("color"),
        spec_exponent=col("spec_exponent"),
        spec_color=col("spec_color"),
        has_reflective=col("has_reflective"),
        has_refractive=col("has_refractive"),
        ior=col("ior"),
        emittance=col("emittance"),
        checker_scale=optional("checker_scale", "checker_scale"),
        checker_color=optional("checker_color", "checker_scale"),
        bump_scale=optional("bump_scale", "bump_strength"),
        bump_strength=optional("bump_strength", "bump_strength"),
        sss_sigma=optional("sss_sigma", "sss_sigma"),
        sss_albedo=optional("sss_albedo", "sss_sigma"),
    )
    gs = T.Geoms(
        type=tuple(int(g["type"]) for g in geoms),
        material_id=np.asarray([g["material_id"] for g in geoms],
                               dtype=np.int32),
        translation=np.asarray([g["translation"] for g in geoms], dtype=f32),
        rotation=np.asarray([g["rotation"] for g in geoms], dtype=f32),
        scale=np.asarray([g["scale"] for g in geoms], dtype=f32),
        velocity=(
            np.asarray([g["velocity"] for g in geoms], dtype=f32)
            if any(any(g["velocity"]) for g in geoms)
            else None  # static scene: no motion-blur cost anywhere
        ),
    )
    if mesh_tris:
        mesh = with_bvh(T.TriMesh(
            tri_verts=np.concatenate(mesh_tris, axis=0).astype(f32),
            tri_geom=np.concatenate(mesh_geom_ids, axis=0),
            tri_uv=(np.concatenate(mesh_uvs, axis=0).astype(f32)
                    if any_mesh_uv else None),
        ), len(geoms))
    else:
        mesh = T.empty_mesh()
    cam_t = T.Camera(
        position=np.asarray(camera["eye"], dtype=f32),
        view=np.asarray(camera["view"], dtype=f32),
        up=np.asarray(camera["up"], dtype=f32),
        fovy_deg=np.asarray(camera["fovy"], dtype=f32),
        aperture=np.asarray(camera["aperture"], dtype=f32),
        focal_dist=np.asarray(camera["focal"], dtype=f32),
    )
    light_indices = tuple(
        i for i, g in enumerate(geoms)
        if materials[g["material_id"]]["emittance"] > 0
    )
    scene = T.Scene(
        materials=mats, geoms=gs, mesh=mesh, camera=cam_t,
        resolution=tuple(camera["resolution"]),
        trace_depth=int(camera["depth"]),
        iterations=int(camera["iterations"]),
        image_name=camera["file"],
        light_indices=light_indices,
    )
    return attach_textures(scene, text, base_dir=base_dir)


def derived_fov(scene: T.Scene):
    """(fovx_deg, fovy_deg) with fovx derived from the aspect ratio, as
    the reference's ``derived_fov`` (src/scene.cpp:133-136)."""
    import math

    fovy = float(scene.camera.fovy_deg)
    yscaled = math.tan(fovy * (PI / 180.0))
    xscaled = (yscaled * scene.width) / scene.height
    fovx = math.atan(xscaled) * 180.0 / PI
    return fovx, fovy
