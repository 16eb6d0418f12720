"""Image output."""

from .image_io import save_png, save_hdr, to_display, to_uint8
