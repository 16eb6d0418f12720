"""Image output with the reference's save conventions.

Counterpart of ``pathtrace_tpu/io/image_io.py``; :func:`save_png`
encodes with the C++ writer of ``native/`` when its library builds, as
the reference's does:

* the saved pixel at (width-1-x, y) is accumulation/(sample count) —
  the x-mirror of src/main.cpp:58;
* PNG: clamp to [0,1], scale by 255, truncate to uint8, RGB;
* HDR: Radiance RGBE, unclamped floats;
* filename: ``<name>.<start time>.<N>samp.<ext>`` (src/main.cpp:62-65).
"""

from __future__ import annotations

import time

import numpy as np


def to_display(accum, width: int, height: int, samples: int) -> np.ndarray:
    """Accumulation buffer (P,3) → mirrored, normalized (H,W,3) float."""
    img = np.asarray(accum, dtype=np.float32).reshape(height, width, 3)
    img = img / max(samples, 1)
    return img[:, ::-1, :]  # the width-1-x mirror (src/main.cpp:58)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp [0,1] → ×255 → uint8 truncation (src/image.cpp:27-33)."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_png(path: str, img: np.ndarray, native=None) -> str:
    """Write ``img`` (H,W,3 float) as an 8-bit RGB PNG (:func:`to_uint8`):
    with the C++ writer (``native/lib.write_png_native``) when its
    library builds and ``native`` is None, with Pillow when ``native`` is
    False or ``PT_NO_NATIVE=1``; ``native=True`` raises
    ``native.lib.NativeError`` when the library cannot be built or
    loaded."""
    u8 = to_uint8(img)
    if native is not False:
        from ..native import lib as N

        if native or N.available():
            N.write_png_native(path, u8)
            return path
    from PIL import Image

    Image.fromarray(u8, mode="RGB").save(path)
    return path


def save_hdr(path: str, img: np.ndarray) -> str:
    """Minimal Radiance HDR (RGBE, flat-run format) writer."""
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    maxc = np.max(img, axis=-1)
    valid = maxc >= 1e-32
    mant, exp = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, mant * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def timestamp() -> str:
    """UTC timestamp string, same shape as currentTimeString
    (src/preview.cpp:13-19)."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())


def render_filename(name: str, start_time: str, samples: int,
                    ext: str = "png") -> str:
    return f"{name}.{start_time}.{samples}samp.{ext}"
