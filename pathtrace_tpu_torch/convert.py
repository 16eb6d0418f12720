"""State carried over from the JAX package, with no import of it.

``from_jax_scene`` reads a ``pathtrace_tpu`` ``Scene`` by attribute name
(its array leaves through ``np.asarray``) into this package's ``Scene``;
``packed_tables_from_numpy``, ``lights_table_from_numpy`` and
``mesh_tables_from_numpy`` turn packed ``cam``/``mats``/``gmat``,
``lights`` and ``tri``/``nodes`` tables (numpy, e.g. from the reference's
``_pack_scene`` and ``_pack_lights``) into device tensors.
The tests use them to make the two packages compute the same thing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import types as T
from .ops.cuda.megakernel import resolve_device


def _arr(x):
    return None if x is None else np.asarray(x)


def _copy(cls, obj, static=()):
    """``cls`` built from ``obj``'s fields of the same names: arrays
    through ``np.asarray``, the names in ``static`` as they are."""
    return cls(**{
        f.name: (getattr(obj, f.name) if f.name in static
                 else _arr(getattr(obj, f.name)))
        for f in dataclasses.fields(cls)
    })


def from_jax_scene(scene) -> T.Scene:
    return T.Scene(
        materials=_copy(T.Materials, scene.materials),
        geoms=_copy(T.Geoms, scene.geoms, static=("type",)),
        mesh=_copy(T.TriMesh, scene.mesh, static=("bvh_meta",)),
        camera=_copy(T.Camera, scene.camera),
        resolution=tuple(scene.resolution),
        trace_depth=int(scene.trace_depth),
        iterations=int(scene.iterations),
        image_name=scene.image_name,
        light_indices=tuple(scene.light_indices),
        textures=tuple(np.asarray(t) for t in scene.textures),
        texture_ids=tuple(scene.texture_ids),
        bump_texture_ids=tuple(scene.bump_texture_ids),
    )


def _tensor(t, device):
    # a copy: the arrays of a JAX package are read-only
    return torch.tensor(np.asarray(t, dtype=np.float32)).to(
        resolve_device(device))


def packed_tables_from_numpy(cam, mats, gmat, device="cuda"):
    """(cam (1,16), mats (G,24), gmat (G,40)) float32 tensors on
    ``device``."""
    return tuple(_tensor(t, device) for t in (cam, mats, gmat))


def lights_table_from_numpy(lights, device="cuda"):
    """A packed NEE light table (L,128) (numpy, e.g. from the
    reference's ``_pack_lights``) as a float32 tensor on ``device``;
    None stays None (a scene with no light)."""
    resolve_device(device)
    return None if lights is None else _tensor(lights, device)


def mesh_tables_from_numpy(tri, nodes, device="cuda"):
    """Packed mesh tables (tri (T,16), nodes (N,16), numpy, e.g. from
    the reference's ``_pack_scene`` BVH branch) as float32 tensors on
    ``device``."""
    return _tensor(tri, device), _tensor(nodes, device)
