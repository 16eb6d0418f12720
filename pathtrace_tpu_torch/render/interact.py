"""Interactive camera control and the restart of the accumulation.

Counterpart of ``pathtrace_tpu/render/interact.py``, the same math on the
host in numpy.  The reference's app (src/main.cpp:72-94,115-137): arrow
keys orbit the view (rotate about the camera's right and up axes by
+-0.1 rad), WASD/RF move the eye by +-0.1 along right/view/up, and any
camera change sets the iteration to 0: the accumulation restarts.  Space
saves the image; Esc (or q) quits.

A headless card has no window, so the key callback becomes a control
file: the terminal viewer (``pathtrace_tpu_torch/tools/watch.py --ctrl``)
appends one key name a line, and the CLI polls the file between chunks
through :class:`InteractiveSession`.  :func:`apply_camera_motion` is the
reference's update: ``r = view x up``, ``rot = R(theta, r) @ R(phi,
up)`` applied to view and up, ``position += move.x*r + move.y*up +
move.z*view``.  Every draw is a function of (iteration, pixel, bounce),
so a restarted accumulation equals a fresh render with the moved camera.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# key -> (theta, phi, move), as src/main.cpp:125-134
KEY_MOTION = {
    "down":  (-0.1, 0.0, (0.0, 0.0, 0.0)),
    "up":    (+0.1, 0.0, (0.0, 0.0, 0.0)),
    "right": (0.0, -0.1, (0.0, 0.0, 0.0)),
    "left":  (0.0, +0.1, (0.0, 0.0, 0.0)),
    "a":     (0.0, 0.0, (-0.1, 0.0, 0.0)),
    "d":     (0.0, 0.0, (+0.1, 0.0, 0.0)),
    "w":     (0.0, 0.0, (0.0, 0.0, +0.1)),
    "s":     (0.0, 0.0, (0.0, 0.0, -0.1)),
    "r":     (0.0, 0.0, (0.0, +0.1, 0.0)),
    "f":     (0.0, 0.0, (0.0, -0.1, 0.0)),
}


def _axis_rotation(angle: float, axis) -> np.ndarray:
    """Rodrigues' rotation matrix about ``axis``, normalised here as
    glm::rotate expects a unit axis (src/main.cpp:79)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(3)
    x, y, z = axis / n
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


def apply_camera_motion(camera, theta: float, phi: float, move):
    """One camera update (src/main.cpp:73-86): view and up rotated by
    ``R(theta, right) @ R(phi, up)``, the eye moved by ``move`` in the
    (right, up, view) basis.  Returns a new Camera (float32 numpy)."""
    v = np.asarray(camera.view, np.float64)
    u = np.asarray(camera.up, np.float64)
    r = np.cross(v, u)
    rot = _axis_rotation(theta, r) @ _axis_rotation(phi, u)
    pos = (np.asarray(camera.position, np.float64)
           + move[0] * r + move[1] * u + move[2] * v)
    return dataclasses.replace(
        camera,
        position=pos.astype(np.float32),
        view=(rot @ v).astype(np.float32),
        up=(rot @ u).astype(np.float32),
    )


class InteractiveSession:
    """Polls a control file for key events and owns the restart rule.

    ``poll(camera)`` reads the lines appended since the last poll and
    returns ``(camera, camera_changed, save, quit)``.  On a camera key the
    caller restarts the accumulation: its iteration back to 0 and its
    image zeroed (src/main.cpp:74)."""

    def __init__(self, ctrl_path: str):
        self.ctrl_path = ctrl_path
        # events written before the render started are stale input
        self._offset = (os.path.getsize(ctrl_path)
                        if os.path.exists(ctrl_path) else 0)

    def _read_new_keys(self):
        try:
            size = os.path.getsize(self.ctrl_path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.ctrl_path, "r") as f:
            f.seek(self._offset)
            chunk = f.read()
        # only whole lines: a writer may be in the middle of one
        upto = chunk.rfind("\n")
        if upto < 0:
            return []
        self._offset += upto + 1
        return [ln.strip().lower() for ln in chunk[:upto + 1].splitlines()
                if ln.strip()]

    def poll(self, camera):
        changed = save = quit_ = False
        for key in self._read_new_keys():
            if key in KEY_MOTION:
                camera = apply_camera_motion(camera, *KEY_MOTION[key])
                changed = True
            elif key == "space":
                save = True
            elif key in ("esc", "escape", "q"):
                quit_ = True
        return camera, changed, save, quit_


def send_key(ctrl_path: str, key: str) -> None:
    """Append one key event (the viewer's side of the protocol)."""
    with open(ctrl_path, "a") as f:
        f.write(key + "\n")
        f.flush()
        os.fsync(f.fileno())
