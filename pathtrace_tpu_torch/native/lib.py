"""ctypes bindings of the native host runtime: the scene parser, the OBJ
loader and the PNG/HDR writers, in C++ (``scene_parser.cpp``,
``obj_loader.cpp``, ``image_writer.cpp``).

Counterpart of ``pathtrace_tpu/native/lib.py``, with the same entry
points: :func:`available`, :func:`load_obj_native`,
:func:`parse_scene_native`, :func:`write_png_native`,
:func:`write_hdr_native` and :class:`NativeError`.  The library is built
at first use by one ``g++`` call (the reference Makefile's flags, zlib
for the PNG writer) into ``pathtrace_tpu_torch/build/`` (not committed),
under a name keyed by the hash of the sources and flags, written to a
private name and renamed into place, so concurrent builds never load a
half-written library.  ``PT_NO_NATIVE=1`` turns the library off.  Each
entry point raises :class:`NativeError` when the library cannot be built
or loaded; ``scene/parser.load_scene`` and ``io/image_io.save_png`` fall
back to their Python paths only when asked to choose (``native=None``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC.parent / "build"
SOURCES = ("scene_parser.cpp", "obj_loader.cpp", "image_writer.cpp")
HEADERS = ("text.h",)
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_error = None  # why the library is unavailable, once a load has failed


class NativeError(RuntimeError):
    pass


def library_path():
    """Where the build of these sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libpathtrace_native_{digest.hexdigest()[:16]}.so"


def _build(out):
    """Compile the sources into ``out``; raises :class:`NativeError` with
    the compiler's output when it fails or is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXXFLAGS, *(str(SRC / s) for s in SOURCES), "-lz", "-o",
           tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise NativeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeError(f"{' '.join(cmd)} failed (exit "
                          f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _declare(lib):
    """The ``argtypes`` and ``restype`` of every entry point."""
    c = ctypes
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    sigs = {
        "pt_parse_scene_file": (c.c_void_p, [c.c_char_p]),
        "pt_parse_scene_text": (c.c_void_p, [c.c_char_p]),
        "pt_scene_error": (c.c_char_p, [c.c_void_p]),
        "pt_scene_counts": (None, [c.c_void_p, c.POINTER(c.c_int32),
                                   c.POINTER(c.c_int32)]),
        "pt_scene_fill_materials": (None, [c.c_void_p] + [f32p] * 13),
        "pt_scene_fill_geoms": (None, [c.c_void_p, i32p, i32p] + [f32p] * 4),
        "pt_scene_fill_camera": (None, [c.c_void_p, i32p, f32p, i32p, i32p,
                                        f32p, f32p, f32p, f32p, f32p]),
        "pt_scene_mesh_path": (c.c_char_p, [c.c_void_p, c.c_int32]),
        "pt_scene_image_name": (c.c_char_p, [c.c_void_p]),
        "pt_scene_free": (None, [c.c_void_p]),
        "pt_load_obj": (c.c_void_p, [c.c_char_p]),
        "pt_obj_error": (c.c_char_p, [c.c_void_p]),
        "pt_obj_tri_count": (c.c_int64, [c.c_void_p]),
        "pt_obj_fill": (None, [c.c_void_p, f32p]),
        "pt_obj_free": (None, [c.c_void_p]),
        "pt_write_png": (c.c_int, [c.c_char_p, c.c_int32, c.c_int32, u8p]),
        "pt_write_hdr": (c.c_int, [c.c_char_p, c.c_int32, c.c_int32, f32p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def get_lib():
    """The loaded library, built at first use; raises
    :class:`NativeError` when ``PT_NO_NATIVE`` is set or the library
    cannot be built or loaded (and again on every later call)."""
    global _lib, _error
    if os.environ.get("PT_NO_NATIVE"):
        raise NativeError("the native library is turned off (PT_NO_NATIVE)")
    if _lib is not None:
        return _lib
    if _error is not None:
        raise NativeError(_error)
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
    except (NativeError, OSError, AttributeError) as e:
        _error = f"native library unavailable: {e}"
        raise NativeError(_error) from e
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads (and ``PT_NO_NATIVE`` is not
    set)."""
    try:
        get_lib()
    except NativeError:
        return False
    return True


def load_obj_native(path: str) -> np.ndarray:
    """The triangles of the OBJ file ``path``, (T,3,3) float32, as
    ``scene/obj.load_obj`` gives them."""
    lib = get_lib()
    h = lib.pt_load_obj(os.fspath(path).encode())
    try:
        err = lib.pt_obj_error(h)
        if err:
            raise NativeError(err.decode())
        t = int(lib.pt_obj_tri_count(h))
        out = np.zeros((t, 3, 3), np.float32)
        if t:
            lib.pt_obj_fill(h, out.reshape(-1))
        return out
    finally:
        lib.pt_obj_free(h)


_VT_LINE = re.compile(rb"^[ \t]*vt[ \t]", re.MULTILINE)


def _mesh_uvs(path, n_tris):
    """The UVs of the OBJ file ``path`` from ``scene/obj.load_obj`` (the
    C++ loader reads vertices only): (T,3,2) float32, or None when the
    file has no ``vt`` line."""
    from ..scene.obj import load_obj

    with open(path, "rb") as f:
        if not _VT_LINE.search(f.read()):
            return None
    tris, uvs = load_obj(path)
    if tris.shape[0] != n_tris:
        raise NativeError(f"{path}: {tris.shape[0]} triangles in Python, "
                          f"{n_tris} in C++")
    return uvs


def parse_scene_native(path: Optional[str] = None,
                       text: Optional[str] = None, base_dir: str = "."):
    """Parse with the C++ parser: the same ``core.types.Scene`` as
    ``scene/parser.parse_scene`` (tests assert it field by field), its
    meshes given their BVH by ``scene/bvh.with_bvh`` and its maps loaded
    by ``scene/textures.attach_textures``.  Raises
    ``FileNotFoundError`` for a missing file and
    ``scene/parser.SceneParseError`` for a malformed one, as the Python
    parser does."""
    from ..core import types as T
    from ..scene.bvh import with_bvh
    from ..scene.parser import SceneParseError
    from ..scene.textures import attach_textures

    lib = get_lib()
    if path is not None:
        h = lib.pt_parse_scene_file(os.fspath(path).encode())
        base_dir = os.path.dirname(os.path.abspath(path))
    else:
        h = lib.pt_parse_scene_text(text.encode())
    try:
        err = lib.pt_scene_error(h)
        if err:
            msg = err.decode()
            if "cannot open" in msg:
                raise FileNotFoundError(msg)
            raise SceneParseError(msg)
        if path is not None:
            with open(path, "r") as f:
                text = f.read()
        n_m, n_g = ctypes.c_int32(), ctypes.c_int32()
        lib.pt_scene_counts(h, ctypes.byref(n_m), ctypes.byref(n_g))
        m, g = n_m.value, n_g.value

        def f32(*shape):
            return np.zeros(shape, np.float32)

        color, spec_ex, spec_c = f32(m, 3), f32(m), f32(m, 3)
        refl, refr, ior, emit = f32(m), f32(m), f32(m), f32(m)
        chk_s, chk_c, bmp_s, bmp_k = f32(m), f32(m, 3), f32(m), f32(m)
        sss_s, sss_a = f32(m), f32(m, 3)
        lib.pt_scene_fill_materials(
            h, color.reshape(-1), spec_ex, spec_c.reshape(-1), refl, refr,
            ior, emit, chk_s, chk_c.reshape(-1), bmp_s, bmp_k, sss_s,
            sss_a.reshape(-1))
        gtype, gmat = np.zeros(g, np.int32), np.zeros(g, np.int32)
        gtr, gro, gsc, gvel = f32(g, 3), f32(g, 3), f32(g, 3), f32(g, 3)
        lib.pt_scene_fill_geoms(h, gtype, gmat, gtr.reshape(-1),
                                gro.reshape(-1), gsc.reshape(-1),
                                gvel.reshape(-1))
        res, iters, depth = (np.zeros(2, np.int32), np.zeros(1, np.int32),
                             np.zeros(1, np.int32))
        fovy, aperture, focal = f32(1), f32(1), f32(1)
        eye, view, up = f32(3), f32(3), f32(3)
        lib.pt_scene_fill_camera(h, res, fovy, iters, depth, eye, view, up,
                                 aperture, focal)
        image_name = lib.pt_scene_image_name(h).decode()

        tris, uvs, tri_geom = [], [], []
        for gi in range(g):
            if gtype[gi] != T.MESH:
                continue
            p = (lib.pt_scene_mesh_path(h, gi) or b"").decode()
            p = os.path.join(base_dir, p)
            tris.append(load_obj_native(p))
            uvs.append(_mesh_uvs(p, tris[-1].shape[0]))
            tri_geom.append(np.full((tris[-1].shape[0],), gi, np.int32))
    finally:
        lib.pt_scene_free(h)

    if tris:
        any_uv = any(u is not None for u in uvs)
        mesh = with_bvh(T.TriMesh(
            tri_verts=np.concatenate(tris, axis=0),
            tri_geom=np.concatenate(tri_geom, axis=0),
            tri_uv=np.concatenate(
                [u if u is not None else np.zeros((t.shape[0], 3, 2),
                                                  np.float32)
                 for t, u in zip(tris, uvs)], axis=0) if any_uv else None,
        ), g)
    else:
        mesh = T.empty_mesh()

    def optional(x, gate):  # an extension's arrays exist only when used
        return x if np.any(gate) else None

    scene = T.Scene(
        materials=T.Materials(
            color=color, spec_exponent=spec_ex, spec_color=spec_c,
            has_reflective=refl, has_refractive=refr, ior=ior,
            emittance=emit,
            checker_scale=optional(chk_s, chk_s),
            checker_color=optional(chk_c, chk_s),
            bump_scale=optional(bmp_s, bmp_k),
            bump_strength=optional(bmp_k, bmp_k),
            sss_sigma=optional(sss_s, sss_s),
            sss_albedo=optional(sss_a, sss_s),
        ),
        geoms=T.Geoms(
            type=tuple(int(t) for t in gtype), material_id=gmat,
            translation=gtr, rotation=gro, scale=gsc,
            velocity=optional(gvel, gvel),
        ),
        mesh=mesh,
        camera=T.Camera(
            position=eye, view=view, up=up,
            fovy_deg=np.asarray(fovy[0]), aperture=np.asarray(aperture[0]),
            focal_dist=np.asarray(focal[0]),
        ),
        resolution=(int(res[0]), int(res[1])),
        trace_depth=int(depth[0]),
        iterations=int(iters[0]),
        image_name=image_name,
        light_indices=tuple(i for i in range(g) if emit[gmat[i]] > 0),
    )
    return attach_textures(scene, text, base_dir=base_dir)


def _check_image(img, channels, dtype):
    img = np.ascontiguousarray(img, dtype=dtype)
    if img.ndim != 3 or img.shape[2] != channels or 0 in img.shape:
        raise ValueError(f"want an (H, W, {channels}) image, got "
                         f"{img.shape}")
    return img


def write_png_native(path: str, rgb_u8: np.ndarray) -> None:
    """Write the (H,W,3) uint8 image ``rgb_u8`` as an 8-bit RGB PNG."""
    lib = get_lib()
    rgb_u8 = _check_image(rgb_u8, 3, np.uint8)
    h, w, _ = rgb_u8.shape
    rc = lib.pt_write_png(os.fspath(path).encode(), w, h, rgb_u8.reshape(-1))
    if rc != 0:
        raise NativeError(f"pt_write_png({path}) failed with code {rc}")


def write_hdr_native(path: str, img_f32: np.ndarray) -> None:
    """Write the (H,W,3) float image ``img_f32`` as a Radiance RGBE file,
    the bytes of ``io/image_io.save_hdr``."""
    lib = get_lib()
    img_f32 = _check_image(img_f32, 3, np.float32)
    h, w, _ = img_f32.shape
    rc = lib.pt_write_hdr(os.fspath(path).encode(), w, h, img_f32.reshape(-1))
    if rc != 0:
        raise NativeError(f"pt_write_hdr({path}) failed with code {rc}")
