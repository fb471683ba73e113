"""Fragment stage math: Blinn-Phong + shadow test, in SoA channels.

Torch counterpart of the parts of ``metalrenderer_tpu.raster.shade`` that
the fused path uses (``_blinn_phong_soa``, ``_shadow_factor_soa``), in the
same expression order, which is also the order of the CUDA fused kernel:
  * fragmentBP_NoShadow / fragmentBP (BlinnPhong.metal:40-58, :60-97):
    ambient + diffuse + specular(half vector, shininess) times the
    material color; the interpolated normal is NOT renormalized;
  * the shadow test (BlinnPhong.metal:79-96): light-space position, the
    ``z*0.5+0.5`` depth remap quirk, the self-consistent viewport mapping
    ``v = (1-ndc.y)/2``, a bilinear REPEAT lookup, bias and factor.
"""
from __future__ import annotations

import torch

from . import sampling


def _rsqrt_norm3(x, y, z):
    """1/||v|| for a 3-vector in SoA channels."""
    return 1.0 / torch.sqrt(x * x + y * y + z * z)


def _blinn_phong_soa(w, n, base, camera_pos, light_pos, light_color,
                     ambient_intensity, shininess):
    """BlinnPhong.metal:44-57 with a point light. Each argument is a tuple
    of channels (or a 3-vector of scalars for positions and colors)."""
    wx, wy, wz = w
    nx, ny, nz = n
    vx = camera_pos[0] - wx
    vy = camera_pos[1] - wy
    vz = camera_pos[2] - wz
    inv = _rsqrt_norm3(vx, vy, vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    lx = light_pos[0] - wx
    ly = light_pos[1] - wy
    lz = light_pos[2] - wz
    inv = _rsqrt_norm3(lx, ly, lz)
    lx, ly, lz = lx * inv, ly * inv, lz * inv
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    inv = _rsqrt_norm3(hx, hy, hz)
    hx, hy, hz = hx * inv, hy * inv, hz * inv

    diff = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
    spec = torch.pow(torch.clamp_min(nx * hx + ny * hy + nz * hz, 0.0),
                     shininess)
    # (ambient + diffuse + specular) shares the lightColor factor.
    s = ambient_intensity + diff + spec
    return (s * light_color[0] * base[0],
            s * light_color[1] * base[1],
            s * light_color[2] * base[2])


def _shadow_factor_soa(w, light_m, depth_map, bias, factor, needs):
    """BlinnPhong.metal:79-96. ``light_m`` = light_proj @ light_view
    (f32[4,4]); ``depth_map`` f32[S, S]; ``needs``: fragments whose material
    runs the test. Returns the factor (``factor`` where shadowed, else 1)
    for those fragments and 1 elsewhere; the map is only read for
    fragments that need it and whose light-space uv lies in [0,1]^2."""
    wx, wy, wz = w
    m = light_m
    lx = m[0, 0] * wx + m[0, 1] * wy + m[0, 2] * wz + m[0, 3]
    ly = m[1, 0] * wx + m[1, 1] * wy + m[1, 2] * wz + m[1, 3]
    lz = m[2, 0] * wx + m[2, 1] * wy + m[2, 2] * wz + m[2, 3]
    lw = m[3, 0] * wx + m[3, 1] * wy + m[3, 2] * wz + m[3, 3]
    inv_w = 1.0 / lw
    u = lx * inv_w * 0.5 + 0.5
    v = (1.0 - ly * inv_w) * 0.5             # self-consistent viewport map
    shadow_depth = lz * inv_w * 0.5 + 0.5    # reference depth remap quirk
    in_bounds = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    mask = in_bounds & needs
    zero = torch.zeros_like(u)
    d = sampling.sample_bilinear(depth_map[..., None],
                                 torch.where(mask, u, zero),
                                 torch.where(mask, v, zero),
                                 sampling.REPEAT)[..., 0]
    shadowed = (shadow_depth - bias) > d
    one = torch.ones_like(u)
    return torch.where(mask & shadowed, factor * one, one)
