"""Texture ingestion + mipmaps (torch counterpart of
``metalrenderer_tpu.io.textures``; Texture.cpp:6-20: stb_image load,
flip-vertical, force RGBA8, upload as RGBA8Unorm).

Decoding happens on the host (PIL if it is installed, else the port's own
PNG decoder). A texture is a tuple of ``f32[H, W, 4]`` mip levels, level 0
first, on the CPU; ``Scene.to(device)`` moves them with the scene.
"""
from __future__ import annotations

import numpy as np
import torch


def _decode(path):
    path = str(path)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    if not path.lower().endswith(".png"):
        raise ValueError(f"no decoder available for {path}")
    from .png import read_png
    img = read_png(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img


def load_texture(path, flip_vertical=True, generate_mips=True):
    """File -> tuple of f32[H, W, 4] mips (level 0 first).

    ``flip_vertical`` mirrors stbi_set_flip_vertically_on_load(true)
    (Texture.cpp:6): image row 0 becomes the BOTTOM of texture space.
    """
    img = _decode(path)
    if flip_vertical:
        img = img[::-1]
    base = torch.from_numpy(np.ascontiguousarray(img.astype(np.float32)
                                                 / np.float32(255.0)))
    if not generate_mips:
        return (base,)
    return build_mipmaps(base)


def from_array(array, flip_vertical=False, generate_mips=True):
    """uint8/float [H,W,3|4] array -> mip pyramid."""
    arr = np.asarray(array)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / np.float32(255.0)
    if arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.ones(arr.shape[:2] + (1,), np.float32)], axis=-1)
    if flip_vertical:
        arr = arr[::-1]
    base = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    if not generate_mips:
        return (base,)
    return build_mipmaps(base)


def build_mipmaps(base):
    """Box-filter mip chain down to 1x1 (power-of-two dims halve exactly;
    odd dims drop the last row/col like Metal's default mipmap generation
    does for NPOT). A texel is (t00 + t01) + (t10 + t11), times 0.25: the
    order in which XLA reduces the JAX package's 2x2 mean."""
    mips = [base]
    cur = base
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(1, cur.shape[0] // 2)
        w = max(1, cur.shape[1] // 2)
        sy = 2 if cur.shape[0] > 1 else 1
        sx = 2 if cur.shape[1] > 1 else 1
        t = cur[:h * sy, :w * sx].reshape(h, sy, w, sx, -1)
        rows = [t[:, dy, :, 0] + t[:, dy, :, 1] if sx == 2 else t[:, dy, :, 0]
                for dy in range(sy)]
        acc = rows[0] + rows[1] if sy == 2 else rows[0]
        nxt = acc * (1.0 / (sy * sx))
        mips.append(nxt.contiguous())
        cur = nxt
    return tuple(mips)


def checkerboard(size=256, squares=8, color_a=(1.0, 1.0, 1.0),
                 color_b=(0.2, 0.6, 0.2)):
    """Procedural test texture (grass-like default, standing in for
    Metal-Tutorial/assets/mc_grass.jpeg in tests)."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // squares
    mask = ((x // cell) + (y // cell)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(color_a, np.float32),
                   np.asarray(color_b, np.float32))
    rgba = np.concatenate([img, np.ones((size, size, 1), np.float32)],
                          axis=-1)
    return build_mipmaps(torch.from_numpy(rgba))
