"""Image textures (the texture-mapping extra): loading and sampling.

Counterpart of ``pathtrace_tpu/scene/textures.py``.  The scene grammar
adds two material lines after the 7 fixed ones:

    TEXTURE tex/wood.png          <- albedo map, multiplied into RGB
    BUMPTEX tex/height.png 0.5    <- height map, normal perturbation k

Paths resolve relative to the scene file.  Maps are decoded with Pillow
to float32 in [0,1] on the u8 grid (k/255, no gamma transform),
deduplicated by absolute path, and downsampled only past the
``MAX_TEX_SIDE`` safety clamp.  The CUDA kernel reads them as one 32-bit
word per texel (``ops/cuda/megakernel.pack_textures``), which is exact
because every texel is k/255.

Sampling is bilinear with repeat wrap in normalized (u, v): [0,1) spans
the image, v = 0 is row 0, texel centres sit at integer + 0.5, and each
tap wraps before the filter (PBRT 10.4's repeat mode).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# Safety clamp only: a larger map is LANCZOS-downsampled to this side.
MAX_TEX_SIDE = 2048


def load_texture(path: str) -> np.ndarray:
    """Decode an image file -> (H, W, 3) float32 in [0,1] on the u8
    grid (values k/255)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w > MAX_TEX_SIDE or h > MAX_TEX_SIDE:
        s = MAX_TEX_SIDE / max(w, h)
        img = img.resize((max(1, round(w * s)), max(1, round(h * s))),
                         Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


def sample_texture(tex, u, v):
    """Bilinear sample with repeat wrap: ``tex`` (H,W,3), ``u``, ``v``
    (...,) float32 tensors in texture space (any real; the fractional
    part is used).  Returns (...,3) float32."""
    tex = torch.as_tensor(tex, dtype=torch.float32, device=u.device)
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # floored modulo, as the reference's jnp.mod (sign of the divisor)
    x0 = torch.remainder(x0f.to(torch.int64), w)
    x1 = torch.remainder(x0 + 1, w)
    y0 = torch.remainder(y0f.to(torch.int64), h)
    y1 = torch.remainder(y0 + 1, h)
    top = tex[y0, x0] * (1.0 - fx) + tex[y0, x1] * fx
    bot = tex[y1, x0] * (1.0 - fx) + tex[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def scan_texture_lines(text):
    """Per-material (texture_path, bump_path, bump_strength) from the
    scene text, ordered by MATERIAL id."""
    out = []
    cur = -1
    for line in text.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "MATERIAL" and len(toks) >= 2:
            cur = int(toks[1])
            while len(out) <= cur:
                out.append([None, None, 0.0])
        elif toks[0] in ("OBJECT", "CAMERA"):
            cur = -1
        elif toks[0] == "TEXTURE" and cur >= 0 and len(toks) >= 2:
            out[cur][0] = toks[1]
        elif toks[0] == "BUMPTEX" and cur >= 0 and len(toks) >= 3:
            out[cur][1] = toks[1]
            out[cur][2] = float(toks[2])
    return [tuple(row) for row in out]


def attach_textures(scene, text, base_dir="."):
    """``scene`` with the TEXTURE/BUMPTEX maps of ``text`` loaded (one
    copy per absolute path): ``textures``, per-material ``texture_ids``
    and ``bump_texture_ids`` (-1: none), and ``bumptex_strength`` when
    some material has a BUMPTEX line (else None)."""
    info = scan_texture_lines(text)
    m_count = scene.materials.count
    while len(info) < m_count:
        info.append((None, None, 0.0))

    textures = []
    index = {}

    def tex_id(rel):
        if rel is None:
            return -1
        p = os.path.abspath(rel if os.path.isabs(rel)
                            else os.path.join(base_dir, rel))
        if p not in index:
            index[p] = len(textures)
            textures.append(load_texture(p))
        return index[p]

    texture_ids = tuple(tex_id(t) for t, _, _ in info[:m_count])
    bump_texture_ids = tuple(tex_id(b) for _, b, _ in info[:m_count])
    strength = (np.asarray([s for _, _, s in info[:m_count]],
                           dtype=np.float32)
                if any(b is not None for _, b, _ in info) else None)
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials,
                                      bumptex_strength=strength),
        textures=tuple(textures),
        texture_ids=texture_ids,
        bump_texture_ids=bump_texture_ids,
    )
