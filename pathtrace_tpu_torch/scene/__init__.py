"""Scene-file parsing."""

from .parser import derived_fov, load_scene, parse_scene
