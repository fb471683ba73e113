"""Texture sampling: a frozen copy of the port's ``raster/sampling.py`` for
the benchmark's reference.

Metal sampler state (mtl_engine.mm:603-612 creates a linear min/mag,
repeat-address sampler for the shadow map) as a plain gather: nearest,
bilinear and trilinear. These are the reference semantics; the kernels of
``sample_cuda`` (bilinear) and ``mip_cuda`` (trilinear) compute the same
functions on the GPU.
"""
from __future__ import annotations

import torch

REPEAT = "repeat"               # MTL::SamplerAddressModeRepeat
CLAMP = "clamp_to_edge"         # MTL::SamplerAddressModeClampToEdge


def _wrap(idx, size, address_mode):
    if address_mode == REPEAT:
        return torch.remainder(idx, size)     # floors, like jnp.mod
    return torch.clamp(idx, 0, size - 1)


def sample_nearest(tex, u, v, address_mode=REPEAT):
    """tex: f32[H,W,C]; u, v: f32[...] in texture space (u right, v down).
    Returns f32[..., C], the texel under (u, v)."""
    h, w = tex.shape[0], tex.shape[1]
    xi = _wrap(torch.floor(u * w).to(torch.int64), w, address_mode)
    yi = _wrap(torch.floor(v * h).to(torch.int64), h, address_mode)
    return tex[yi, xi]


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


def sample_trilinear(mips, u, v, lod, address_mode=REPEAT):
    """Trilinear: bilinear in two adjacent mip levels, blended by frac(lod).

    ``mips``: tuple of f32[H_i, W_i, C], mips[0] the base level; ``lod``:
    f32[...] level of detail (0 = base), clipped to the chain.
    """
    n = len(mips)
    if n == 1:
        return sample_bilinear(mips[0], u, v, address_mode)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    lo = torch.floor(lod)
    frac = (lod - lo)[..., None]
    lo_i = lo.to(torch.int64)
    acc_lo = sample_bilinear(mips[0], u, v, address_mode)
    acc_hi = sample_bilinear(mips[1], u, v, address_mode)
    for level in range(1, n):
        sel = (lo_i == level)[..., None]
        acc_lo = torch.where(sel, sample_bilinear(mips[level], u, v,
                                                  address_mode), acc_lo)
        acc_hi = torch.where(sel, sample_bilinear(
            mips[min(level + 1, n - 1)], u, v, address_mode), acc_hi)
    return acc_lo * (1.0 - frac) + acc_hi * frac


def mip_level_from_uv_derivatives(du_dx, dv_dx, du_dy, dv_dy, tex_w, tex_h):
    """Standard isotropic LOD: log2 of the max screen-space texel footprint."""
    ax, bx = du_dx * tex_w, dv_dx * tex_h
    ay, by = du_dy * tex_w, dv_dy * tex_h
    fx = torch.sqrt(ax * ax + bx * bx)
    fy = torch.sqrt(ay * ay + by * by)
    rho = torch.maximum(fx, fy)
    return torch.log2(torch.clamp_min(rho, 1e-12))
