"""Scene data model as plain dataclasses (struct-of-arrays).

Counterpart of ``pathtrace_tpu/core/types.py`` with the JAX pytree
registration dropped: every array field is a numpy array (host side)
that ``ops/cuda/megakernel.pack_scene`` turns into device tensors, or a
float32 CPU tensor, which may require grad: the gradient routes
(``render/diff.py``) put the parameters of ``split_params`` back as
such tensors, and the packing keeps their graph.  Field names, shapes
and the static/leaf split are the reference's, so a scene converts
field by field (``convert.from_jax_scene``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

# Geometry type codes (src/sceneStructs.h:8-11 has SPHERE, CUBE; MESH is
# the reserved extension at README.md:236-237).
SPHERE = 0
CUBE = 1
MESH = 2


@dataclass
class Materials:
    """SoA material table; every array has leading axis M."""

    color: Any          # (M, 3) diffuse albedo (RGB)
    spec_exponent: Any  # (M,)   SPECEX
    spec_color: Any     # (M, 3) SPECRGB
    has_reflective: Any  # (M,)  REFL (specular-lobe probability)
    has_refractive: Any  # (M,)  REFR
    ior: Any            # (M,)   REFRIOR
    emittance: Any      # (M,)   EMITTANCE; light iff > 0
    checker_scale: Any = None   # (M,)   CHECKER extension (None = off)
    checker_color: Any = None   # (M, 3)
    bump_scale: Any = None      # (M,)   BUMP extension (None = off)
    bump_strength: Any = None   # (M,)
    sss_sigma: Any = None       # (M,)   SSS extension (None = off)
    sss_albedo: Any = None      # (M, 3)
    bumptex_strength: Any = None  # (M,) BUMPTEX extension (None = off)

    @property
    def count(self):
        return self.color.shape[0]


@dataclass
class Geoms:
    """SoA geometry instances.  ``type`` is a tuple of ints: primitive
    kinds are scene structure, fixed for the life of the scene."""

    type: tuple       # (G,) SPHERE / CUBE / MESH
    material_id: Any  # (G,) int32
    translation: Any  # (G, 3)
    rotation: Any     # (G, 3) degrees (Euler XYZ, applied T@Rx@Ry@Rz@S)
    scale: Any        # (G, 3)
    velocity: Any = None  # (G, 3) MOTION extension; None = static

    @property
    def count(self):
        return len(self.type)


@dataclass
class TriMesh:
    """Triangle soup for MESH geoms, object space (``tri_verts.shape[0]
    == 0`` means no mesh).  The ``bvh_*`` fields are filled at load time
    by ``scene/bvh.with_bvh``: the node table, the triangle order and
    one ``(geom, node_off, n_nodes, tri_off, n_tris)`` entry per MESH
    geom."""

    tri_verts: Any  # (T, 3, 3)
    tri_geom: Any   # (T,) int32
    tri_uv: Any = None      # (T, 3, 2) or None
    bvh_nodes: Any = None
    bvh_order: Any = None
    bvh_meta: tuple = ()

    @property
    def count(self):
        return self.tri_verts.shape[0]


@dataclass
class Camera:
    position: Any    # (3,) EYE
    view: Any        # (3,) VIEW
    up: Any          # (3,) UP
    fovy_deg: Any    # ()   FOVY (vertical half-angle in degrees)
    aperture: Any    # ()   lens radius; 0 disables depth-of-field
    focal_dist: Any  # ()   focal-plane distance for DoF


@dataclass
class Scene:
    """Full scene: arrays plus static render settings from the CAMERA
    block.  ``texture_ids``/``bump_texture_ids`` hold one index per
    material (-1 = none)."""

    materials: Materials
    geoms: Geoms
    mesh: TriMesh
    camera: Camera
    resolution: tuple   # (width, height)
    trace_depth: int
    iterations: int
    image_name: str
    light_indices: tuple = ()
    textures: Any = ()
    texture_ids: tuple = ()
    bump_texture_ids: tuple = ()

    @property
    def width(self):
        return self.resolution[0]

    @property
    def height(self):
        return self.resolution[1]

    @property
    def pixel_count(self):
        return self.resolution[0] * self.resolution[1]


def empty_mesh(dtype=np.float32) -> TriMesh:
    return TriMesh(
        tri_verts=np.zeros((0, 3, 3), dtype=dtype),
        tri_geom=np.zeros((0,), dtype=np.int32),
    )
