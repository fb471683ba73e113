"""Texture sampling (torch counterpart of ``metalrenderer_tpu.raster.sampling``).

Metal sampler state (mtl_engine.mm:603-612 creates a linear min/mag,
repeat-address sampler for the shadow map) as a plain gather.
"""
from __future__ import annotations

import torch

REPEAT = "repeat"               # MTL::SamplerAddressModeRepeat
CLAMP = "clamp_to_edge"         # MTL::SamplerAddressModeClampToEdge


def _wrap(idx, size, address_mode):
    if address_mode == REPEAT:
        return torch.remainder(idx, size)     # floors, like jnp.mod
    return torch.clamp(idx, 0, size - 1)


def sample_bilinear(tex, u, v, address_mode=REPEAT):
    """Bilinear filtering with a half-texel-centered footprint
    (MTL::SamplerMinMagFilterLinear semantics).

    tex: f32[H, W, C]; u, v: f32[...] in texture space (u right, v down).
    Returns f32[..., C].
    """
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    xa = _wrap(x0i, w, address_mode)
    xb = _wrap(x0i + 1, w, address_mode)
    ya = _wrap(y0i, h, address_mode)
    yb = _wrap(y0i + 1, h, address_mode)
    t00 = tex[ya, xa]
    t10 = tex[ya, xb]
    t01 = tex[yb, xa]
    t11 = tex[yb, xb]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy
