"""Scene-file parsing."""

from .parser import load_scene, parse_scene
