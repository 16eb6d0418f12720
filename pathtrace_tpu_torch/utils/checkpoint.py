"""Checkpoint and resume for progressive renders.

Counterpart of ``pathtrace_tpu/utils/checkpoint.py``.  A render's whole
mutable state is (the accumulated image, the iteration count), as in the
reference's app (src/pathtrace.cu:70-71).  Every random draw is a pure
function of (iteration, pixel, bounce, draw), so a render resumed at
iteration k, with the same chunk boundaries, is bit-identical to one
that never stopped.  A fingerprint of the scene guards against resuming
onto another scene.  The file is the reference's: ``np.savez_compressed``
of ``accum``, ``iteration`` and ``fingerprint``, written atomically.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _update(h, name, value):
    """Hash ``value`` under ``name``: a dataclass field by field, a tuple
    or list item by item, an array (numpy or a tensor, wherever it lies)
    by its dtype, shape and bytes, anything else by its repr."""
    h.update(name.encode())
    if dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            _update(h, f"{name}.{f.name}", getattr(value, f.name))
    elif isinstance(value, (tuple, list)):
        h.update(f"[{len(value)}]".encode())
        for i, v in enumerate(value):
            _update(h, f"{name}[{i}]", v)
    elif torch.is_tensor(value) or isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(_host(value))
        h.update(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
    else:
        h.update(repr(value).encode())


def scene_fingerprint(scene) -> str:
    """A stable hash (16 hex digits) of every field of the ``Scene``
    dataclass, its arrays' bytes included (numpy or tensors), and of its
    resolution, depth and image name."""
    h = hashlib.sha256()
    h.update(json.dumps([list(scene.resolution), int(scene.trace_depth),
                         scene.image_name]).encode())
    _update(h, "scene", scene)
    return h.hexdigest()[:16]


def save(path: str, accum, iteration: int, scene) -> None:
    """Write ``accum`` (copied to the host), ``iteration`` and the scene's
    fingerprint to ``path`` through ``path.tmp`` and ``os.replace``, so a
    reader never sees half a file."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        accum=_host(accum),
        iteration=np.int64(iteration),
        fingerprint=np.bytes_(scene_fingerprint(scene).encode()),
    )
    # np.savez appends .npz to a path without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load(path: str, scene):
    """(accum (P,3) float32 numpy, iteration) from ``path``; raises
    ``ValueError`` when the checkpoint was made for another scene."""
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != scene_fingerprint(scene):
            raise ValueError(
                f"checkpoint was created for a different scene "
                f"(fingerprint {fp} != {scene_fingerprint(scene)})")
        return z["accum"].copy(), int(z["iteration"])
