"""Textures of the benchmark's reference: a frozen copy of the port's
``io/textures.py`` ``from_array(..., generate_mips=True)`` and
``build_mipmaps``, the mip chain a scene's texture is sampled from."""
from __future__ import annotations

import numpy as np
import torch


def from_array(array):
    """float [H, W, 3|4] (or uint8) array -> its mip chain, float32
    [h, w, 4] levels on the CPU."""
    arr = np.asarray(array)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / np.float32(255.0)
    if arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.ones(arr.shape[:2] + (1,), np.float32)], axis=-1)
    return build_mipmaps(torch.from_numpy(np.ascontiguousarray(arr,
                                                               np.float32)))


def build_mipmaps(base):
    """Box-filter mip chain down to 1x1 (power-of-two dims halve exactly;
    odd dims drop the last row/col like Metal's default mipmap generation
    does for NPOT). A texel is (t00 + t01) + (t10 + t11), times 0.25."""
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
