"""Scene configurations for the port's feature tests (CPU and GPU).

The shipped scene files, and the variants of
``pathtrace_tpu_torch.scene.variants`` built from their text.  Imports no
JAX, so the GPU-only tests can use it where JAX is not installed.
"""

import dataclasses
import os

import numpy as np

import pathtrace_tpu_torch as ptt
from pathtrace_tpu_torch.ops.cuda import megakernel as K
from pathtrace_tpu_torch.scene.variants import (  # noqa: F401
    BUMP, MESH_BUMP, MESH_GLASS, MESH_MOTION, MESH_TEX, MESH_TWICE,
    SPHERE_LIGHT, SSS, TEX512, TEX_CHECKER, edit_text,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
# the image-texture configurations (K4), same layout
TEX_CONFIGS = {
    "cornell_tex": ("cornell_tex", (), False, False),
    "cornell_tex-nee": ("cornell_tex", (), True, False),
    "cornell_tex512": ("cornell_tex", (TEX512,), False, False),
    "tex_checker": ("cornell_tex", (TEX_CHECKER,), False, False),
    "cornell_bumpmesh": ("cornell_bumpmesh", (), False, False),
    "cornell_bigmesh_tex": ("cornell_bigmesh_tex", (), False, False),
    "mesh_tex": ("cornell_bumpmesh", (MESH_TEX,), False, False),
}


def mesh_rig_text():
    """The text of the mesh rig of the reference's
    ``tests/test_vjp_kernel.py`` (its ``MESH_RIG``: a light, a floor and
    an icosahedron, 12x12 depth 2), read from that file; its OBJ path is
    relative to the repo root."""
    with open(os.path.join(REPO, "tests", "test_vjp_kernel.py")) as f:
        return f.read().split('MESH_RIG = """\\\n')[1].split('"""')[0]


def mesh_rig(res=None):
    """The port's scene of the mesh rig (:func:`mesh_rig_text`), at
    ``res`` (its own 12x12 by default)."""
    scene = ptt.parse_scene(mesh_rig_text(), base_dir=REPO)
    return scene if res is None else dataclasses.replace(scene,
                                                         resolution=res)


def scene_text(name, edits=()):
    with open(os.path.join(REPO, "scenes", f"{name}.txt")) as f:
        return edit_text(f.read(), edits)


def load(name, edits=(), res=None, depth=None):
    s = ptt.parse_scene(scene_text(name, edits),
                        base_dir=os.path.join(REPO, "scenes"))
    return dataclasses.replace(s, resolution=res or s.resolution,
                               trace_depth=depth or s.trace_depth)


def job(config, res, depth, device="cpu"):
    """The job (``megakernel.prepare``'s) of ``config`` (of ``CONFIGS``,
    ``MESH_CONFIGS`` or ``TEX_CONFIGS``)."""
    name, edits, nee, rr = {**CONFIGS, **MESH_CONFIGS, **TEX_CONFIGS}[config]
    return K.prepare(load(name, edits, res, depth), device, nee=nee, rr=rr)


def tree_equal(a, b, path="scene"):
    """Two scenes (or any of their fields) field by field: the same
    types, dtypes, shapes and values."""
    assert type(a) is type(b), (path, type(a), type(b))
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            tree_equal(getattr(a, f.name), getattr(b, f.name),
                       f"{path}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path
